"""Host ms a block inside Radiod._finish_block (RTP packetisation and
beacons) over the window, from the benchmark's wrapper; paced cells."""


def read(run):
    if run["loop"] != "paced" or "host_ms" not in run or not run["blocks"]:
        return None
    return run["host_ms"]["emit"] / run["blocks"]
