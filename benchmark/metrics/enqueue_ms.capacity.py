"""Host ms a block inside Radiod.step (the GraphStep's replay enqueue) over
the window, from the benchmark's wrapper; flat cells."""


def read(run):
    if run["loop"] != "flat" or "host_ms" not in run or not run["blocks"]:
        return None
    return run["host_ms"]["enqueue"] / run["blocks"]
