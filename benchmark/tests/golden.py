"""Digests of the plain reference's float64 results and of the generator's
rings, at a small ring of each cell's configuration, on the CPU: what
test_bench_reference.py and test_bench_scene.py hold the harness to.

    python benchmark/tests/golden.py <a benchmark directory> > benchmark/tests/data/golden.json

records them from the harness in that directory (its reference.py and
scene.py): data/golden.json was recorded so from the harness before its
detectors and signals were split into files of their own, on an x86_64 CPU
with AVX512 under PyTorch 2.13.0+cpu and NumPy 2.0.2 (its "build"). The
digests are of float64 arithmetic on that build; another build may round
differently, so each array is also recorded as a few of its values and its
RMS (`summary`), which any build must reproduce to rounding.
"""
from __future__ import annotations

import copy
import hashlib
import json
import platform
import sys
from pathlib import Path

SEED, BLOCKS, FIRST = 2**31 + 5, 400, 4  # 8 s: the AGCs have come up to the tones
CELLS = ("hf-farm.busy", "hf-generic.live")


def _digest(a) -> str:
    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def summary(a) -> list[float]:
    """Eight of a's values, evenly spaced through it flattened, and its RMS."""
    import numpy as np

    f = np.asarray(a, np.float64).reshape(-1)
    pick = f[np.linspace(0, f.size - 1, 8).astype(np.int64)]
    return [float(v) for v in pick] + [float(np.sqrt(np.mean(f * f)))]


def close(got: list, want: list, rel: float, steps: float = 0.0) -> bool:
    """Two summaries equal to rounding: each value within rel x the recorded
    RMS (plus `steps`), the RMS within rel of the recorded one."""
    import numpy as np

    rms = want[-1]
    near = np.abs(np.array(got[:-1]) - np.array(want[:-1])) <= rel * rms + steps
    return bool(np.all(near)) and abs(got[-1] - rms) <= rel * rms


def build() -> dict:
    """What the float64 digests hold for: the libraries and the CPU."""
    import numpy as np
    import torch

    return {"torch": torch.__version__, "numpy": np.__version__, "machine": platform.machine(),
            "cpu_capability": torch.backends.cpu.get_cpu_capability()}


def small_workload(wl: dict) -> dict:
    """The cell's traffic on a ring of 2 blocks, at most 16 tones a group."""
    wl = copy.deepcopy(wl)
    wl["ring_blocks"] = 2
    for t in wl.get("tones", []):
        if isinstance(t.get("select"), dict):
            t["select"] = {"strata": min(int(t["select"]["strata"]), 16)}
    return wl


def digests(bench: Path) -> dict:
    """{cell: {"ring", "sends": {group}, "x": {group}, "gain": {group},
    "values": {"ring", "x": {group}, "gain": {group}}}}, {"small": {"ring",
    "values": {"ring"}}} (the tests' small configuration) and {"build"}."""
    import numpy as np

    from reference import Reference
    from scene import make_scene

    try:
        from cell import traffic
    except ImportError:  # a harness whose generator takes the whole workload
        traffic = dict
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from conftest import SMALL_CFG, SMALL_WL

    ring = make_scene(SMALL_CFG["reference"], traffic(SMALL_WL), SEED, "cpu").ring.numpy()
    out = {"build": build(), "small": {"ring": _digest(ring), "values": {"ring": summary(ring)}}}
    for cell in CELLS:
        wl = small_workload(json.loads((bench / "workloads" / f"{cell}.json").read_text()))
        cfg = json.loads((bench / "configs" / f"{wl['config']}.json").read_text())
        sc = make_scene(cfg["reference"], traffic(wl), SEED, "cpu")
        ref = Reference(cfg["reference"], sc.ring, device="cpu")
        d = {"ring": _digest(sc.ring.numpy()), "sends": {}, "x": {}, "gain": {},
             "values": {"ring": summary(sc.ring.numpy()), "x": {}, "gain": {}}}
        for g, a in ref.sends(BLOCKS, FIRST).items():
            d["sends"][g] = _digest(a)
        for g in ref.groups:
            idx = np.array(sorted(sc.tones.get(g.name, {}))[:4] or list(range(min(g.C, 4))))
            a = ref.audio(g.name, idx, BLOCKS, FIRST)
            d["x"][g.name], d["gain"][g.name] = _digest(a["x"]), _digest(a["gain"])
            d["values"]["x"][g.name] = summary(a["x"])
            d["values"]["gain"][g.name] = summary(a["gain"])
        out[cell] = d
    return out


if __name__ == "__main__":
    bench = Path(sys.argv[1]).resolve()
    sys.path[:0] = [str(bench), str(bench.parent)]
    print(json.dumps(digests(bench), indent=1, sort_keys=True))
