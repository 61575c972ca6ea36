#!/usr/bin/env python3
"""The benchmark of radiod-torch (ka9q_radio_tpu_torch): one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds BENCHMARK.json. The last line of
standard output is the run's JSON result; the numbers compared to decide
`correct` are the last lines of standard error. Needs a CUDA card; without
one it prints no result and exits 2.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

T_START = time.monotonic()
HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # every build and kernel cache of the run at a fixed place in the checkout
    build = ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    sys.path[:0] = [str(HERE), str(ROOT)]
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    import cell

    return cell.main(bench, args, T_START)


if __name__ == "__main__":
    sys.exit(main())
