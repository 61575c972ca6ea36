"""One run of one benchmark cell: radiod-torch's Radiod on one card, driven
through Radiod.step_block for the window, its RTP received by a process of
its own, then judged against the plain reference.

The run, in order:
  set-up   the cell's scene (a ring of A/D blocks made on the card from the
           seed), the receiver process, Radiod as radiod-torch builds it
           from the configuration's text (kernel and native-edge builds are
           cache hits in the checkout's build/ after a checkout's first run),
           and warm-up dispatches that meet every graph the window will;
  window   `seconds` of dispatches, flat out (the next dispatch when
           step_block returns) or paced at the A/D's rate (dispatch j handed
           over when its last sample is due), the card's time in the
           engine steps on CUDA events (CardClock);
  trace    (--trace 1) the host split of the window by wrappers around
           Radiod's stages, a profiled stretch of dispatches, and each
           group's kernels timed by CUDA events at the cell's shapes;
  check    the receiver's datagrams against the reference (judge.py), once
           the program's state is freed.
Everything a cell, a configuration or a metric needs is found by name:
workloads/<cell>.json, configs/<config>.json, metrics/<metric>.py, and
(named.py) each group's detectors/<demod>.py and each kind of signal's
signals/<kind>.py.
"""
from __future__ import annotations

import gc
import json
import multiprocessing as mp
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from judge import as_payloads, gain_reading, judge, wave_errors
from named import SetupError, module
from reference import Reference
from scene import make_scene
from trace import event_ms, traced

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ka9q_radio_tpu")
CHECKS = ("packets_off", "wave_lsb", "gain_db")  # the numbers that decide `correct`
# the keys of a workload that the harness reads itself; the rest is the
# traffic generator's (scene.py)
HARNESS_KEYS = ("config", "why", "loop", "warmup_dispatches", "trace_dispatches", "compare")


# what radiod-torch's RTP front end holds of its A/D stream (RtpSource's
# max_buffer_s): a block whose dispatch returns later than this after its
# last sample was due has lost its samples in a deployment
BUFFER_S = 2.0


def load(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.exists():
        raise SetupError(f"no {kind[:-1]} named {name!r} ({path.relative_to(HERE.parent)})")
    return json.loads(path.read_text())


def traffic(wl: dict) -> dict:
    """The entries of workload `wl` that the generator reads, in their order."""
    return {k: v for k, v in wl.items() if k not in HARNESS_KEYS}


def reader(name: str):
    """metrics/<name>.py as a module: read(run) -> value or None, and
    optionally after_window(ctx) called while the daemon lives."""
    return module("metrics", name)


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics this cell reports in a run of this kind."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key] if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> list[str]:
    return sorted({k.split(".")[0] for k in list(sys.modules)} & set(FORBIDDEN))


def _free_ports(n: int) -> list[int]:
    """n free UDP ports on 127.0.0.1, none the next of another (a daemon's
    RTCP goes to its data port + 1)."""
    out: list[int] = []
    while len(out) < n:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.bind(("127.0.0.1", 0))
        p = s.getsockname()[1]
        s.close()
        if all(abs(p - q) > 1 for q in out):
            out.append(p)
    return out


def config_text(cfg: dict) -> tuple[str, dict, list[int]]:
    """The configuration's text with its {status}, {data} and {data:<section>}
    placeholders given ports; returns (text, {placeholder: port}, the data
    ports)."""
    import re

    names = sorted(set(re.findall(r"\{(status|data(?::[^}]+)?)\}", cfg["text"])))
    ports = dict(zip(names, _free_ports(len(names))))
    text = cfg["text"]
    for k, p in ports.items():
        text = text.replace("{" + k + "}", str(p))
    return text, ports, [p for k, p in ports.items() if k.startswith("data")]


def compare_set(ref: Reference, scene, wl: dict, seed: int) -> list[tuple[str, np.ndarray]]:
    """[(group, channel indices)] whose audio is held: a group whole, or a
    sample drawn from the seed of the channels that carry a tone."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 7]))
    out = []
    for c in wl["compare"]:
        g = next(gr for gr in ref.groups if gr.name == c["group"])
        sel = c.get("select", "all")
        if sel == "all":
            idx = np.arange(g.C)
        else:
            toned = np.array(sorted(scene.tones.get(g.name, {})), np.int64)
            n = min(int(sel["tones"]), toned.size)
            idx = np.sort(rng.choice(toned, n, replace=False))
        out.append((g.name, idx))
    return out


def _power_limit() -> "str | None":
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout.strip() else None
    except (OSError, subprocess.SubprocessError):
        return None


class Wrappers:
    """The host's time inside Radiod's stages, from the benchmark's files:
    `step` (the GraphStep replay's enqueue), `_fetch_out` (the wait for the
    card and the device->host copy), `_finish_block` (RTP and beacons), each
    also a profiler span while a trace records."""

    STAGES = {"enqueue": "step", "fetch": "_fetch_out", "emit": "_finish_block"}

    def __init__(self, rd):
        self.rd = rd
        self.ms = dict.fromkeys(self.STAGES, 0.0)
        self.orig = {k: getattr(rd, a) for k, a in self.STAGES.items()}
        for k, a in self.STAGES.items():
            setattr(rd, a, self._wrap(k, self.orig[k]))

    def _wrap(self, k, fn):
        ms = self.ms

        def wrapped(*args):
            with torch.profiler.record_function(k):
                t = time.perf_counter()
                r = fn(*args)
                ms[k] += (time.perf_counter() - t) * 1e3
                return r
        return wrapped

    def reset(self):
        for k in self.ms:
            self.ms[k] = 0.0

    def remove(self):
        for k, a in self.STAGES.items():
            setattr(self.rd, a, self.orig[k])


class CardClock:
    """The card's seconds in the window's engine steps: CUDA events on the
    step's stream around every replay of the step (GraphStep._replay: its
    captured graph, or its graphless branch), read once the window has
    closed. `pairs` holds one pair a replay: a dispatch that the step runs
    eagerly passes no replay and is not timed."""

    def __init__(self, rd, dev):
        self.stepper = rd._stepper
        self.pairs: list = []
        stream, orig, pairs = torch.cuda.current_stream(dev), self.stepper._replay, self.pairs

        def replay(*args):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record(stream)
            r = orig(*args)
            e1.record(stream)
            pairs.append((e0, e1))
            return r
        self.stepper._replay = replay

    def remove(self) -> None:
        del self.stepper._replay

    def seconds(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs) / 1e3


def _emission_paths(rd) -> dict:
    paths = {}
    for name, g in rd.engine.groups.items():
        if name in rd.edges:
            edge_chans = rd.edges[name][1]
            big = len(edge_chans) >= rd.big_group_c
            paths[name] = ("native edge, indexed sendmmsg" if g.spec.egress_slots
                           else "native edge, sendmmsg") + (", staggered beacons" if big
                                                             else ", per-channel beacons")
        else:
            paths[name] = "Python per-channel RTP"
    return paths


def _close(rd) -> None:
    for edge, _ in list(rd.edges.values()):
        edge.close()
    rd.edges = {}
    for name in ("data_sock", "status_sock", "status_in", "rtcp_sock"):
        s = getattr(rd, name, None)
        if s is not None:
            s.close()
            setattr(rd, name, None)


def run_cell(bench: dict, cell: str, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", wl: "dict | None" = None, cfg: "dict | None" = None) -> dict:
    """One run; returns the result line's dict (and `checks`). wl, cfg:
    the workload and configuration in place of the files of those names."""
    from ka9q_radio_tpu_torch.config import load_config
    from ka9q_radio_tpu_torch.runtime.radiod import Radiod

    wl = wl if wl is not None else load("workloads", cell)
    cfg = cfg if cfg is not None else load("configs", wl["config"])
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    scene = make_scene(cfg["reference"], traffic(wl), seed, dev)
    D = int(cfg["reference"].get("time_shards", 0))
    per = max(D, 1)
    if scene.ring.shape[0] % per:
        raise SetupError(f"ring_blocks {scene.ring.shape[0]} is not whole dispatches of {per}")
    blocktime = float(cfg["reference"].get("blocktime", 0.02))
    text, ports, data_ports = config_text(cfg)
    ref_plan = Reference(cfg["reference"], scene.ring[:1], device=dev)  # SSRCs of the compare set
    compare = compare_set(ref_plan, scene, wl, seed)
    ssrcs = ref_plan.ssrcs()
    keep = sorted({int(s) for g, idx in compare for s in ssrcs[g][idx]})
    ctx = mp.get_context("spawn")
    conn, child = ctx.Pipe()
    import receiver

    rx_proc = ctx.Process(target=receiver.serve, args=(child, data_ports, keep), daemon=True)
    rx_proc.start()
    rd = None
    try:
        if not conn.poll(60):
            raise SetupError("the receiver process did not start within 60 s")
        status, granted = conn.recv()
        if status != "ready":
            raise SetupError(f"the receiver did not start: {status}")
        # the program's own peak: the harness's input ring and plan, already
        # on the card, are taken off (the ring is reported on its own)
        base = 0
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
        try:
            rd = Radiod(load_config(text), use_network=True, data_port=data_ports[0],
                        status_port=ports["status"], device=device)
        except Exception as e:  # noqa: BLE001 - any set-up error fails the run, named
            raise SetupError(f"Radiod's construction failed: {type(e).__name__}: {e}") from e
        b = 0
        R = scene.ring.shape[0]

        def dispatch():
            nonlocal b
            with torch.profiler.record_function("input"):
                blk = scene.ring[b % R: b % R + D] if D else scene.ring[b % R]
            rd.step_block(block=blk)
            b += per

        try:
            for _ in range(int(wl.get("warmup_dispatches", 4))):
                dispatch()
            if on_card:
                torch.cuda.synchronize(dev)
        except Exception as e:  # noqa: BLE001
            raise SetupError(f"a warm-up dispatch failed: {type(e).__name__}: {e}") from e
        captures0 = rd.graph_stats()["current"]["captures"]
        wraps = Wrappers(rd) if trace else None
        drops0, over0 = rd.block_drops, rd.egress_overflows
        first = b
        paced = wl["loop"] == "paced"
        lat_ms: list[float] = []
        late = lost_blocks = 0
        card = CardClock(rd, dev) if on_card else None
        t_w = time.monotonic()
        setup_s = t_w - t_start
        period = per * blocktime  # s between dispatches: the A/D's own rate
        if paced:
            j = 0
            while True:
                due = t_w + j * period
                if due >= t_w + seconds:
                    break
                now = time.monotonic()
                if due - now > 0.001:
                    time.sleep(due - now - 0.0005)
                while time.monotonic() < due:
                    pass
                dispatch()
                done = time.monotonic()
                lat_ms.append((done - due) * 1e3)
                late += done > due + period
                if done - due > BUFFER_S:
                    lost_blocks += per
                j += 1
            wall = time.monotonic() - t_w
        else:
            ends = []
            while time.monotonic() - t_w < seconds:
                dispatch()
                ends.append(time.monotonic() - t_w)
            wall = time.monotonic() - t_w
        window_blocks = b - first
        if card is not None:
            card.remove()
        mem_peak = torch.cuda.max_memory_allocated(dev) - base if on_card else 0
        if paced:
            # the 95th percentile is shown and not a metric: it spreads too widely between runs
            steady = {"latency_ms_quarters": [float(np.median(q)) for q in
                                              np.array_split(np.asarray(lat_ms), 4)],
                      "latency_ms_p95": float(np.percentile(lat_ms, 95))}
        else:  # the rate in each quarter of the window: drift within a run
            parts = [q for q in np.array_split(np.arange(len(ends)), 4) if len(q)]
            steady = {"capacity_x_quarters": [
                float(len(q) * per * blocktime / (ends[q[-1]] - (ends[q[0] - 1] if q[0] else 0.0)))
                for q in parts]}
        run = {"loop": wl["loop"], "blocks": window_blocks, "window_s": wall,
               "blocktime": blocktime, "setup_s": setup_s, "latency_ms": lat_ms,
               "dispatches": window_blocks // per, "cell": cell, "late_dispatches": late,
               "card_s": card.seconds() if card else None,
               "card_replays": len(card.pairs) if card else 0}
        captures_in_window = rd.graph_stats()["current"]["captures"] - captures0
        # a block fails where it is lost: dropped, past the egress slots, or
        # (paced) handed back after the front end would have overwritten it.
        # A dispatch that ends after the next was due and within the buffer
        # is late, not lost: the latency counts it, and late_pct.latency
        failed = (rd.block_drops - drops0) + (rd.egress_overflows - over0) + lost_blocks
        readers = {m["name"]: reader(m["name"]) for m in cell_metrics(bench, cell, trace)}
        if trace:
            run["host_ms"] = dict(wraps.ms)
            wraps.reset()
            nt = int(wl.get("trace_dispatches", 8))

            def body():  # paced from its own start, after the profiler's
                t_tr = time.monotonic()
                for j in range(nt):
                    if paced:
                        due = t_tr + (j + 1) * period
                        while time.monotonic() < due:
                            time.sleep(0.0002)
                    dispatch()

            run["trace"] = traced(body) if on_card else None
            if run["trace"] is not None:
                run["trace"]["blocks"] = nt * per
            run["kernels"] = kernel_rooflines(rd, scene, cfg) if on_card else {}
            wraps.remove()
        actx = {"rd": rd, "run": run}
        for mod in readers.values():
            if hasattr(mod, "after_window"):
                mod.after_window(actx)
        blocks_run = b
        paths = _emission_paths(rd)
        graphs = rd.graph_stats()["current"]
        found = forbidden_modules()
        if found:
            raise SetupError(f"modules of the JAX package or JAX are loaded: {found}")
    finally:
        try:
            conn.send("stop")
        except (BrokenPipeError, OSError):
            pass
        if rd is not None:
            _close(rd)
        rx = conn.recv() if conn.poll(30) else None
        rx_proc.join(timeout=30)
        if rx_proc.is_alive():
            rx_proc.kill()
            rx_proc.join()
    if rx is None or not isinstance(rx, dict):
        raise SetupError("the receiver process gave no result")
    del rd, actx
    gc.collect()
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    t_check = time.monotonic()
    ref = Reference(cfg["reference"], scene.ring, device=dev)
    checks = judge(rx, ref, compare, first, blocks_run)
    check_s = time.monotonic() - t_check
    metrics = {}
    units = {m["name"]: m["unit"] for m in cell_metrics(bench, cell, trace)}
    for name, mod in readers.items():
        v = mod.read(run)
        if v is not None:
            metrics[name] = {"value": float(v), "unit": units[name]}
    result = {
        "correct": all(checks[k]["value"] <= checks[k]["limit"] for k in CHECKS),
        "attempted": window_blocks, "failed": int(failed), "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": int(mem_peak)},
        "cell": cell, "seed": seed, "setup_s": setup_s, "window_s": wall, "check_s": check_s,
        "blocks_run": blocks_run, **steady,
        "input_ring_bytes": scene.ring.numel() * scene.ring.element_size(),
        "window_first_block": first, "captures_in_window": captures_in_window,
        "graphs": {"dispatch": graphs["dispatch"], "captures": graphs["captures"],
                   "replays": graphs["replays"], "eager_blocks": graphs["eager_blocks"]},
        "emission": paths, "receiver": {"datagrams": int(len(rx["ssrc"])),
                                        "rcvbuf_granted": rx["rcvbuf_granted"],
                                        "rcvbuf_errors": rx["rcvbuf_errors"]},
        "check_detail": checks["detail"],
        "card_s": run["card_s"], "card_replays": run["card_replays"],
        "late_dispatches": late, "lost_blocks": lost_blocks,
        "latency_ms_max": max(lat_ms) if lat_ms else None,
    }
    if trace and run.get("trace") is not None:
        tr = run["trace"]
        result["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    if on_card:
        result["card"] = _power_limit()
    result["checks"] = {k: checks[k] for k in CHECKS}
    return result


def kernel_rooflines(rd, scene, cfg) -> dict:
    """Each group's kernel A and kernel B, through the engine's op entries,
    timed by CUDA events around a graph of 20 calls on a master spectrum of
    the cell's first block, beside the bound counted from the group's shapes
    (peaks.py): {"channelize": [(bound ms, ms), ...], "noise_est": [...]}."""
    from peaks import channelize_bound_ms, noise_est_bound_ms

    eng = rd.engine
    ref = Reference(cfg["reference"], scene.ring[:1], device=scene.ring.device,
                    dtype=torch.float32)
    _, F = eng.master_step(eng.init_state()["master"], scene.ring[0])
    out: dict = {"channelize": [], "noise_est": []}
    for rg in ref.groups:
        g = eng.groups[rg.name]
        params = rd.params[rg.name]
        if g.tile_E is not None:
            ms = event_ms(lambda: g._channelize(params, F))
            out["channelize"].append(
                (channelize_bound_ms(rg.shift, rg.n, rg.olen, ref.m.bins, ref.m.real), ms))
        ms = event_ms(lambda: g._noise_est(params, F))
        out["noise_est"].append((noise_est_bound_ms(rg.noise_lo, rg.W, ref.m.bins), ms))
    return out


def control_readings(cell: str, seed: int, blocks: int, device: str = "cuda",
                     wl: "dict | None" = None, cfg: "dict | None" = None) -> dict:
    """The control of the cell's comparison and a planted gain fault, each
    the plain reference put in the program's place and judged against the
    float64 reference over the blocks a run of the cell judges (from the end
    of its warm-up to `blocks`): `control`, computed in float32 with a TF32
    channel IDFT; `gain_fault`, in float64 with each group's detector's
    fault (its `fault`: linear's and FM's, every headroom and fixed gain 3
    dB off); beside them `float32`, in float32 alone, which should read as
    the program does. Returns {number: {reading: worst value}}."""
    wl = wl if wl is not None else load("workloads", cell)
    cfg = cfg if cfg is not None else load("configs", wl["config"])
    dev = torch.device(device)
    scene = make_scene(cfg["reference"], traffic(wl), seed, dev)
    per = max(int(cfg["reference"].get("time_shards", 0)), 1)
    first = int(wl.get("warmup_dispatches", 4)) * per
    faulty = dict(cfg["reference"], groups=[module("detectors", g["demod"]).fault(g)
                                            for g in cfg["reference"]["groups"]])
    ref = Reference(cfg["reference"], scene.ring, device=dev)
    sides = {"control": Reference(cfg["reference"], scene.ring, device=dev, dtype=torch.float32,
                                  tf32=True),
             "gain_fault": Reference(faulty, scene.ring, device=dev),
             "float32": Reference(cfg["reference"], scene.ring, device=dev, dtype=torch.float32)}
    out = {"wave_lsb": dict.fromkeys(sides, 0.0), "gain_db": dict.fromkeys(sides, 0.0)}
    for g, idx in compare_set(ref, scene, wl, seed):
        want = ref.audio(g, idx, blocks, first)
        for name, r in sides.items():
            got = r.audio(g, idx, blocks, first)
            e, db = wave_errors(as_payloads(got, first), want, first)
            out["wave_lsb"][name] = max(out["wave_lsb"][name], float(np.nanmax(e)))
            out["gain_db"][name] = max(out["gain_db"][name], gain_reading(db))
    return out


def main(bench: dict, args, t_start: float) -> int:
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("benchmark: no CUDA device (torch.cuda.is_available() is false): no result",
              file=sys.stderr)
        return 2
    wl_names = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in wl_names:
        print(f"benchmark: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    need = int(wl_names[args.workload]["chips"])
    if torch.cuda.device_count() < need:
        print(f"benchmark: the cell needs {need} cards, {torch.cuda.device_count()} seen",
              file=sys.stderr)
        return 2
    try:
        res = run_cell(bench, args.workload, args.seed, float(args.seconds), bool(args.trace),
                       t_start)
    except SetupError as e:
        print(f"benchmark: FAILED: {e}", file=sys.stderr)
        return 1
    found = forbidden_modules()
    if found:
        print(f"benchmark: modules of JAX or the JAX package are loaded: {found}", file=sys.stderr)
        return 1
    for k, c in res["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 0
