"""The device's idle share over the traced dispatches: 100 x (1 - busy
seconds / wall seconds), busy the union of the device operations' intervals
in the torch.profiler trace; flat cells."""


def read(run):
    tr = run.get("trace")
    if run["loop"] != "flat" or not tr or tr["busy_s"] <= 0 or not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
