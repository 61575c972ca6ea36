"""Share of kernel A's channel-blocks that its persistent design carried:
100 x Radiod.channelize_counts()'s persist_rows / a_rows, since the
daemon's construction; paced cells. Nothing where the program has no such
counter."""


def after_window(ctx):
    counts = getattr(ctx["rd"], "channelize_counts", None)
    if counts is not None:
        ctx["run"]["channelize_counts"] = counts()


def read(run):
    c = run.get("channelize_counts")
    if run["loop"] != "paced" or not c or not c["a_rows"]:
        return None
    return 100.0 * c["persist_rows"] / c["a_rows"]
