"""Host ms a block inside Radiod._fetch_out (the wait for the card and the
device->host copy) over the window, from the benchmark's wrapper; flat cells."""


def read(run):
    if run["loop"] != "flat" or "host_ms" not in run or not run["blocks"]:
        return None
    return run["host_ms"]["fetch"] / run["blocks"]
