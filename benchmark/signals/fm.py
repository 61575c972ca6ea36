"""FM carriers: one on each chosen channel's dial, modulated by a tone.

    "fm": [{"group": name, "select": "all" | {"strata": n}, "dbfs": v,
            "tone_hz": f, "deviation_hz": d}]

The phase of each carrier is drawn from the seed."""
from __future__ import annotations


def add(entries: list, ctx) -> None:
    for t in entries:
        freqs = ctx.dials[t["group"]]
        for k in ctx.select(t.get("select", "all"), len(freqs)):
            ctx.carrier(freqs[k], 10.0 ** (float(t["dbfs"]) / 20.0), float(t["tone_hz"]),
                        float(t["deviation_hz"]), ctx.rng.random())
