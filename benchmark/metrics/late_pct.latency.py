"""Paced: the share of the window's dispatches that returned after the next
one was due (%). Late, not lost: the front end holds their samples."""


def read(run):
    if run["loop"] != "paced" or not run["dispatches"]:
        return None
    return 100.0 * run["late_dispatches"] / run["dispatches"]
