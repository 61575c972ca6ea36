"""Channels a block that the per-channel loop of Radiod._finish_block walks:
Radiod.emission_counts()'s walked / blocks, since the daemon's construction;
flat cells. Nothing where the program has no such counter."""


def after_window(ctx):
    counts = getattr(ctx["rd"], "emission_counts", None)
    if counts is not None:
        ctx["run"]["emission_counts"] = counts()


def read(run):
    c = run.get("emission_counts")
    if run["loop"] != "flat" or not c or not c["blocks"]:
        return None
    return c["walked"] / c["blocks"]
