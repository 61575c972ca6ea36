"""The card's headroom over its A/D, flat out: the window's blocks x the
block time / the card's seconds in the window's engine steps (CUDA events
around every replay of the step, cell.CardClock). Nothing where a window
dispatch went unreplayed: its card time is unknown."""


def read(run):
    if run["loop"] != "flat" or not run["card_s"] or run["card_replays"] != run["dispatches"]:
        return None
    return run["blocks"] * run["blocktime"] / run["card_s"]
