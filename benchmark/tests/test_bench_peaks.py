"""The yardstick of the kernels' roofline shares (peaks.py) against counts
made by hand: on a complex master a channel's tile rows and its N0 window's
bins wrap through DC, each distinct row or bin read once; on the two cells'
real masters the counts are those of the formulas before complex masters
were taken (frozen below)."""
from __future__ import annotations

import json

import numpy as np
import pytest
from conftest import BENCH

from peaks import FP32_OPS_S, INT32_OPS_S, TF32_OPS_S, TILE, bound_ms, channelize_bound_ms, \
    noise_est_bound_ms
from reference import Master, _Group, parse_freq

N_CH, OLEN = 300, 240  # a 12 kHz channel's bins and output samples (the cells' geometry)
BINS = 8 * TILE  # a complex master of 8 tile rows


def _channelize_by_hand(rows: int, C: int) -> float:
    S = 4 * TILE  # ceil(300 / 128) + 1 whole rows cover any 300-bin slice
    nbytes = rows * TILE * 8 + C * S * 8 + N_CH * OLEN * 8 + C * OLEN * 8 + 3 * C * 4
    nops = 6 * C * S + 2 * C * (S - N_CH) + 8 * C * N_CH * OLEN + 8 * C * OLEN
    return bound_ms(nbytes, (3 * nops, TF32_OPS_S))


@pytest.mark.parametrize("shifts, rows", [
    ([0], 4),  # straddles DC: rows -2..1, i.e. 6, 7, 0, 1
    ([-512], 4),  # at the negative band edge: rows -6..-3, i.e. 2..5
    ([0, -512], 8),  # the two together cover the master once
    ([0, -362], 6),  # rows 6, 7, 0, 1 and 4..7: 6 and 7 once
    ([200, 200 - BINS], 4),  # one slice, its shift given unsigned and signed
])
def test_a_complex_masters_tile_rows_wrap_through_dc(shifts, rows):
    got = channelize_bound_ms(np.array(shifts), N_CH, OLEN, BINS, real=False)
    assert got == pytest.approx(_channelize_by_hand(rows, len(shifts)), rel=1e-12)
    # a row more or less moves the bound: the count is what is held
    assert got != pytest.approx(_channelize_by_hand(rows + 1, len(shifts)), rel=1e-6)


def _noise_by_hand(bins: int, C: int, W: int) -> float:
    return bound_ms(bins * 8 + C * 16, (C * W * 5, FP32_OPS_S), (C * W, INT32_OPS_S))


@pytest.mark.parametrize("starts, bins", [
    ([-40], 80),  # straddles DC: -40..39
    ([-BINS // 2], 80),  # from the negative band edge
    ([-40, 0], 120),  # overlapping windows: 0..39 once
    ([-40, BINS - 40], 80),  # one window, its start given signed and unsigned
    ([-40, -BINS // 2], 160),
])
def test_a_complex_masters_noise_bins_wrap_through_dc(starts, bins):
    got = noise_est_bound_ms(np.array(starts), 80, BINS)
    want = _noise_by_hand(bins, len(starts), 80)
    assert got == pytest.approx(want, rel=1e-12)
    assert got != pytest.approx(_noise_by_hand(bins + 1, len(starts), 80), rel=1e-9)


def _channelize_real_frozen(shifts, n, olen, master_bins):
    C = len(shifts)
    S = (-(-n // TILE) + 1) * TILE
    n_rows = -(-master_bins // TILE)
    lo = (np.asarray(shifts, np.int64) - n // 2) // TILE
    lo = np.clip(lo, 0, max(n_rows - S // TILE, 0))
    rows = np.unique(lo[:, None] + np.arange(S // TILE))
    nbytes = rows.size * TILE * 8 + C * S * 8 + n * olen * 8 + C * olen * 8 + 3 * C * 4
    nops = 6 * C * S + 2 * C * (S - n) + 8 * C * n * olen + 8 * C * olen
    return bound_ms(nbytes, (3 * nops, TF32_OPS_S))


def _noise_real_frozen(window_lo, W):
    C = len(window_lo)
    bins = np.unique(np.asarray(window_lo, np.int64)[:, None] + np.arange(W)).size
    return bound_ms(bins * 8 + C * (4 + 4 + 8), (C * W * 5, FP32_OPS_S), (C * W, INT32_OPS_S))


@pytest.mark.parametrize("config", ["hf-farm", "hf-generic"])
def test_the_cells_real_masters_count_as_before(config):
    ref = json.loads((BENCH / "configs" / f"{config}.json").read_text())["reference"]
    m = Master.of_entry(ref)
    assert m.real
    for spec in ref["groups"]:
        g = _Group(spec, m, parse_freq(ref.get("frequency", 0.0)))
        assert channelize_bound_ms(g.shift, g.n, g.olen, m.bins, m.real) == \
            _channelize_real_frozen(g.shift, g.n, g.olen, m.bins)
        assert noise_est_bound_ms(g.noise_lo, g.W, m.bins) == _noise_real_frozen(g.noise_lo, g.W)
