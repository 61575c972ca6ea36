"""Share of the linear demodulators' channel-blocks that the fused
linear_tail kernel carried: 100 x Radiod.tail_counts()'s fused_rows /
linear_rows, since the daemon's construction; flat cells. Nothing where
the program has no such counter."""


def after_window(ctx):
    counts = getattr(ctx["rd"], "tail_counts", None)
    if counts is not None:
        ctx["run"]["tail_counts"] = counts()


def read(run):
    c = run.get("tail_counts")
    if run["loop"] != "flat" or not c or not c["linear_rows"]:
        return None
    return 100.0 * c["fused_rows"] / c["linear_rows"]
