"""The daemon's headroom over its A/D, flat out: the window's blocks x the
block time / the window's wall seconds (1.0 keeps up exactly)."""


def read(run):
    if run["loop"] != "flat" or not run["window_s"]:
        return None
    return run["blocks"] * run["blocktime"] / run["window_s"]
