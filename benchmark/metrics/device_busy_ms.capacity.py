"""Device ms a block over the traced dispatches: the union of the device
operations' intervals in the torch.profiler trace / the blocks; flat cells."""


def read(run):
    tr = run.get("trace")
    if run["loop"] != "flat" or not tr or tr["busy_s"] <= 0:
        return None
    return tr["busy_s"] * 1e3 / tr["blocks"]
