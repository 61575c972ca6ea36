"""Tones: a carrier above each chosen channel's dial.

    "tones": [{"group": name, "select": "all" | {"strata": n},
               "dbfs": v | [lo, hi], "offset_hz": v | [lo, hi]}]

Each chosen channel's tone is drawn from the seed (offset, then level, then
phase) and put at the nearest whole cycles a block; the tone is recorded
(Scene.tones) as (Hz above the dial, dBFS)."""
from __future__ import annotations

from scene import STEP_DB, STEP_HZ


def add(entries: list, ctx) -> None:
    for t in entries:
        freqs = ctx.dials[t["group"]]
        chosen = ctx.tones.setdefault(t["group"], {})
        for k in ctx.select(t.get("select", "all"), len(freqs)):
            off = ctx.draw(t.get("offset_hz", 1500.0), STEP_HZ)
            db = ctx.draw(t.get("dbfs", -80.0), STEP_DB)
            # whole cycles a block, counted from the tuner's centre
            f = round((freqs[k] + off - ctx.center) / ctx.grid) * ctx.grid + ctx.center
            chosen[k] = (f - freqs[k], db)
            ctx.carrier(f, 10.0 ** (db / 20.0), phase=ctx.rng.random())
