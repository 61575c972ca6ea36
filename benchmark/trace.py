"""Device time from a torch.profiler trace, and the CUDA-event timing of an op.

`traced(body)` runs body() under the profiler (CPU and CUDA activity) and
reduces the trace to what the benchmark reports: the seconds in which some
operation ran on the device (the union of the kernels', copies' and sets'
intervals), the wall length of the traced window, the device operations
that took most time, and the longest idle gaps on the device, each named by
the benchmark's host span (`record_function`) that was open at the gap's
middle. `event_ms(fn)` times one call of fn on the device: n calls captured
in one CUDA graph, replayed between two CUDA events (a copy of the smoke
test's event_ms).
"""
from __future__ import annotations

import time

import torch

__all__ = ["SPANS", "traced", "event_ms"]

SPANS = ("input", "enqueue", "fetch", "emit")


def traced(body) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        body()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    evs = prof.events()
    # the device's operations: kernels, copies, sets (the benchmark's own
    # spans also show on the device's timeline, as annotations, and are not)
    dev = sorted(((e.time_range.start, e.time_range.end, e.name) for e in evs
                  if e.device_type == DeviceType.CUDA and e.name not in SPANS
                  and e.time_range.end > e.time_range.start), key=lambda r: r[0])
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in evs
                   if e.device_type == DeviceType.CPU and e.name in SPANS)
    busy_us, cur_s, cur_e = 0.0, None, None
    gaps = []
    for s, e, _ in dev:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    by_name: dict[str, float] = {}
    for s, e, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    def named(a: float, b: float) -> str:
        mid = 0.5 * (a + b)
        best = [n for s, e, n in spans if s <= mid <= e]
        return best[-1] if best else "harness"

    idle = sorted(((named(a, b), (b - a) * 1e-6) for a, b in gaps), key=lambda r: -r[1])[:10]
    return {"busy_s": busy_us * 1e-6, "window_s": wall, "device_events": len(dev),
            "device_ops": [[n[:120], v] for n, v in ops], "idle_gaps": [[n, v] for n, v in idle]}


def event_ms(fn, n: int = 20, warm: int = 3) -> float:
    """Device ms of one call of fn: n calls in one CUDA graph between two
    CUDA events, over n (warmed up on a side stream first)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warm):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(n):
            fn()
    torch.cuda.synchronize()
    graph.replay()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    graph.replay()
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / n
    graph.reset()
    return ms
