"""The comparison that decides `correct`: the RTP datagrams the receiver got
against the plain reference.

Three numbers, each with its limit (PERF.md gives the readings they were
set from):

* `packets_off`: over every channel of every group and every block from the
  window's start to the run's end, the channel-blocks whose datagram is
  missing, doubled or unexpected by the reference's squelch `send` flags,
  plus datagrams under an SSRC or timestamp no channel has, plus each
  datagram whose payload is not the block's olen x rails samples (counted
  besides its presence). An exact comparison: the squelch decisions, egress
  compaction and packetisation.
* `wave_lsb`: over the compared channels (a sample drawn from the seed) and
  the same blocks, the worst error, in s16 steps, of a block's audio against
  the reference detector's output times a smooth gain, beyond the s16
  rounding: the block's gain (a quadratic in time over the block, the form
  of the AGC's exponential ramp to well under a step) is fitted by least
  squares, and the residual's mean square less 1/12 (a step's rounding) is
  the block's error squared. A muted block's payload is compared with
  silence. The waveform and the squelch's silence are held here.
* `gain_db`: the departure, in dB, of each block's fitted gain (its mean)
  from the reference's (the AGC's, or a fixed gain's), over the blocks that
  are not muted; per compared channel its 90th percentile over the blocks,
  and the worst channel's. The AGC decides once a block on comparisons that
  are equal up to rounding (knife edges), so float32 and float64 take
  different branches now and then and part by up to 2 dB for a few blocks
  (the worst block swings from seed to seed; it is reported in the
  detail); a wrong headroom or fixed gain departs in every block, a wrong
  recovery rate in every block of a ramp.
"""
from __future__ import annotations

import numpy as np

__all__ = ["LIMITS", "judge", "wave_errors", "gain_reading", "presence", "packets_off"]

# the limits: each between the largest reading of sound runs over a dozen
# seeds and the smallest of the control (PERF.md, section 2)
LIMITS = {"packets_off": 0, "wave_lsb": 0.6, "gain_db": 1.2}
UNBOUNDED = 1e9  # reported for an infinite reading (a wrong-sized payload, no positive gain)


def presence(rx: dict, ssrc_map: dict, olens: dict, first: int, blocks: int,
             rails: dict) -> tuple[dict, int, dict]:
    """Datagram counts [blocks - first, C] per group from the receiver's
    (ssrc, ts, size) arrays, the count of datagrams under no channel or
    outside the blocks run, and per group the count of counted datagrams
    whose payload is not the block's olen x rails ({group: [blocks - first,
    C]}) s16 samples."""
    cnt = {g: np.zeros((blocks - first, len(s)), np.int64) for g, s in ssrc_map.items()}
    ss = np.frombuffer(rx["ssrc"], np.uint32).astype(np.int64)
    ts = np.frombuffer(rx["ts"], np.uint32).astype(np.int64)
    size = np.frombuffer(rx["size"], np.uint32).astype(np.int64)
    known = np.zeros(ss.size, bool)
    stray, wrong = 0, {}
    for g, s in ssrc_map.items():
        order = np.argsort(s)
        pos = np.clip(np.searchsorted(s[order], ss), 0, s.size - 1)
        hit = s[order][pos] == ss
        known |= hit
        i, t = order[pos[hit]], ts[hit]
        b, r = np.divmod(t, olens[g])
        stray += int(np.count_nonzero((r != 0) | (b >= blocks)))
        ok = (r == 0) & (b >= first) & (b < blocks)
        bi, ci = b[ok] - first, i[ok]
        np.add.at(cnt[g], (bi, ci), 1)
        wrong[g] = int(np.count_nonzero(size[hit][ok] != 2 * olens[g] * rails[g][bi, ci]))
    return cnt, stray + int(np.count_nonzero(~known)), wrong


def packets_off(rx: dict, ssrc_map: dict, olens: dict, first: int, blocks: int,
                dec: dict) -> tuple[int, dict]:
    """`packets_off` and its detail, from the receiver's arrays and the
    reference's decisions ({group: {"send", "rails"}}, [blocks - first, C]):
    every channel-block's datagrams against its `send` flag, the stray
    datagrams and the wrong-sized ones."""
    cnt, stray, wrong = presence(rx, ssrc_map, olens, first, blocks,
                                 {g: d["rails"] for g, d in dec.items()})
    off = stray
    detail: dict = {"stray_datagrams": stray, "by_group": {}}
    for g, c in cnt.items():
        want = dec[g]["send"].astype(np.int64)
        bad = int(np.abs(c - want).sum()) + wrong[g]
        off += bad
        detail["by_group"][g] = {"datagrams": int(c.sum()), "due": int(want.sum()),
                                 "wrong_size": wrong[g], "off": bad}
    return off, detail


def wave_errors(pay: list, ref: dict, first: int) -> tuple[np.ndarray, np.ndarray]:
    """([B', K] excess error in s16 steps, [B', K] gain departure in dB) of
    each compared channel-block, its worst rail's; nan where no payload came
    (and the gain's where the block is muted). pay[k] maps block -> s16
    samples (float) of channel k, the rails interleaved sample by sample;
    ref is Reference.audio()'s dict for blocks first.. . A payload of other
    than olen x the block's rails samples reads infinite. Per rail the
    residual is p - G(t) x with G a quadratic over the block fitted by
    least squares (a muted block: p itself); its RMS less the s16
    rounding's (1/12 step^2). The departure is |20 log10| of G's mean over
    the reference's, infinite where G's mean is not positive."""
    x_all = ref["x"] * 32767.0
    g_ref = ref["gain"].mean(-1)
    mute, rails = ref["mute"], ref["rails"]
    B, K, P, n = x_all.shape
    u = (np.arange(n) - (n - 1) / 2.0) / n
    out = np.full((B, K), np.nan)
    gain = np.full((B, K), np.nan)
    for k in range(K):
        for j in range(P):
            rows = [i for i in range(B) if first + i in pay[k] and rails[i, k] > j]
            if not rows:
                continue
            got = [pay[k][first + i] for i in rows]
            wrong = np.array([q.size != n * rails[i, k] for q, i in zip(got, rows)])
            p = np.stack([np.zeros(n) if w else q[j::rails[i, k]]
                          for q, w, i in zip(got, wrong, rows)])
            x = x_all[rows, k, j]
            A = np.stack([x, x * u, x * u * u], -1)  # [R, n, 3]
            G = np.einsum("rni,rnj->rij", A, A) + 1e-30 * np.eye(3)
            coef = np.linalg.solve(G, np.einsum("rni,rn->ri", A, p)[..., None])[..., 0]
            mean = coef[:, 0] + coef[:, 2] / 12.0
            muted = mute[rows, k]
            coef = np.where(muted[:, None], 0.0, coef)
            res = p - np.einsum("rni,ri->rn", A, coef)
            ms = np.mean(res ** 2, -1)
            ratio = np.where(mean > 0, mean, 1.0) / g_ref[rows, k]
            e = np.where(wrong, np.inf, np.sqrt(np.maximum(ms - 1.0 / 12.0, 0.0)))
            db = np.where(wrong, np.inf, np.where(muted, np.nan, np.where(
                mean > 0, np.abs(20.0 * np.log10(ratio)), np.inf)))
            out[rows, k] = np.fmax(out[rows, k], e)
            gain[rows, k] = np.fmax(gain[rows, k], db)
    return out, gain


def gain_reading(db: np.ndarray) -> float:
    """`gain_db` of [B', K] block departures (nan: no payload, or muted;
    inf: no positive gain): the worst compared channel's 90th percentile
    over its blocks, taken as one of them (an infinite one stays so)."""
    cols = [c[~np.isnan(c)] for c in db.T]
    return max((float(np.quantile(c, 0.9, method="higher")) for c in cols if c.size), default=0.0)


def judge(rx: dict, reference, compare: list, first: int, blocks: int) -> dict:
    """The compared numbers of one run. compare: [(group, [channel index,
    ...])] of the channels whose audio is held. Returns {name: {"value":
    v, "limit": LIMITS[name]}} plus "detail"."""
    ssrc_map = reference.ssrcs()
    olens = {g.name: g.olen for g in reference.groups}
    off, detail = packets_off(rx, ssrc_map, olens, first, blocks,
                              reference.decisions(blocks, first))
    worst, worst_db, worst_block_db, n_cmp = 0.0, 0.0, 0.0, 0
    for g, idx in compare:
        ss = ssrc_map[g][idx]
        pay = []
        for s in ss:
            d = {}
            for t, p in rx["kept"].get(int(s), []):
                b, r = divmod(int(t), olens[g])
                if not r:
                    d[b] = np.frombuffer(p, ">i2").astype(np.float64)
            pay.append(d)
        ref = reference.audio(g, idx, blocks, first)
        e, db = wave_errors(pay, ref, first)
        vals = e[~np.isnan(e)]
        if vals.size:
            worst = max(worst, float(vals.max()))
        worst_db = max(worst_db, gain_reading(db))
        if np.any(~np.isnan(db)):
            worst_block_db = max(worst_block_db, float(np.nanmax(db)))
        n_cmp += int(vals.size)
        detail.setdefault("wave_lsb_median", {})[g] = float(np.median(vals)) if vals.size else None
    detail["compared_channel_blocks"] = n_cmp
    detail["gain_db_worst_block"] = min(worst_block_db, UNBOUNDED)
    return {"packets_off": {"value": off, "limit": LIMITS["packets_off"]},
            "wave_lsb": {"value": min(worst, UNBOUNDED), "limit": LIMITS["wave_lsb"]},
            "gain_db": {"value": min(worst_db, UNBOUNDED), "limit": LIMITS["gain_db"]},
            "detail": detail}


def as_payloads(got: dict, first: int) -> list[dict]:
    """A reference's audio (Reference.audio()'s dict: [B', K, P, olen] and
    the rails of each block) as the s16 payloads the program would send,
    per channel {block: samples, the rails interleaved}: a control's output
    put in the program's place."""
    a = np.round(np.clip(got["audio"] * 32767.0, -32768.0, 32767.0))
    r = got["rails"]
    return [{first + j: a[j, k, :r[j, k]].T.reshape(-1).astype(np.float64)
             for j in range(a.shape[0])} for k in range(a.shape[1])]
