"""The daemon's headroom over its A/D on the host's clock, flat out: the
window's blocks x the block time / the window's wall seconds (1.0 keeps up
exactly). The host's speed swings twofold from second to second on the
card's machine, and this reading with it, so it is a per-layer metric."""


def read(run):
    if run["loop"] != "flat" or not run["window_s"]:
        return None
    return run["blocks"] * run["blocktime"] / run["window_s"]
