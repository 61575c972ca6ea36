"""Paced at the A/D's rate: the median over the window's dispatches of
step_block's return minus the time its last input sample was due (ms)."""
import numpy as np


def read(run):
    if run["loop"] != "paced" or not run["latency_ms"]:
        return None
    return float(np.percentile(run["latency_ms"], 50))
