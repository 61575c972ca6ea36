#!/usr/bin/env python3
"""The control of a cell's comparison, on the card: the plain reference put
in the program's place in float32 with a TF32 channel IDFT, and in float64
with every headroom and fixed gain 3 dB off (and beside them in float32
alone), judged by `wave_lsb` and `gain_db` against the float64 reference
over the blocks a run of the cell judges. A control that reads under the
cell's limits would let a TF32 channelizer or a wrong gain pass; PERF.md
gives the readings.

    python3 benchmark/control.py --workload <cell> --blocks <n> --seeds a,b,c

--blocks: the blocks a run of the cell reaches (its warm-up's and window's,
from a run's `blocks_run`). One JSON line a seed.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--blocks", type=int, required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path[:0] = [str(HERE), str(HERE.parent)]
    import cell

    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.monotonic()
        r = cell.control_readings(args.workload, seed, args.blocks, device=args.device)
        print(json.dumps({"workload": args.workload, "seed": seed, "blocks": args.blocks,
                          **r, "seconds": time.monotonic() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
