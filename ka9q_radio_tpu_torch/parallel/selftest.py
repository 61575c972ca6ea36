"""Flagship-geometry correctness drive of the sharded engine (SURVEY 7.6).

Runs the flagship geometry, N = 3,240,000 real master (the reference's
rof3240000 plan, docs/FFTW3.md:57-61) with a 1,000-channel SSB group and a
16-channel spectrum sweep, through BOTH the single-device engine and the
sharded engine (distributed digit-order master, C/D channel rows a device)
and asserts that the audio agrees to FFT roundoff over a run of several
blocks with a retune at block 3 and a channel-table grow at block 6 (the
dynamic-create path: a new engine, migrate_state, adopt_host_params).

Used by the tests (a mesh of CPU devices, a small geometry), by
chip_smoke.py (D shards of one card, the flagship) and by dryrun_multichip.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .sharding import Mesh, Sharded, make_mesh

__all__ = ["flagship_parity", "dryrun_multichip", "params_ptrs"]

FLAGSHIP_FS = 129_600_000.0
FALLBACK_FS = 2_048_000.0  # L 40,960, N 51,200 = 2^11 5^2: splits for any 2^k mesh


def _flagship_groups(FS: float, n_hf: int, n_sweep: int):
    from ..runtime import ChannelSpec, GroupSpec

    freqs = np.linspace(0.02 * FS, 0.48 * FS, n_hf)
    sfreqs = np.linspace(0.05 * FS, 0.45 * FS, n_sweep)
    return [
        GroupSpec(name="hf", demod="linear", samprate=12_000, snr_squelch=True,
                  channels=tuple(ChannelSpec(freq=float(f), low=50.0, high=3000.0)
                                 for f in freqs)),
        GroupSpec(name="sweep", demod="spectrum", samprate=32_400, bin_bw=1000.0,
                  bin_count=128,
                  channels=tuple(ChannelSpec(freq=float(f)) for f in sfreqs)),
    ]


def params_ptrs(params) -> list:
    """The data pointers of every tensor of a params tree (every shard of a
    Sharded leaf), in tree order: unchanged across an in-place retune."""
    out = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, Sharded):
            out.extend(s.data_ptr() for s in t.shards)
        elif torch.is_tensor(t):
            out.append(t.data_ptr())

    walk(params)
    return out


def flagship_parity(mesh: Mesh, nblocks: int = 10, n_hf: int = 1000, n_sweep: int = 16,
                    FS: float = FLAGSHIP_FS, rtol: float = 2e-3, atol: float = 1e-4) -> dict:
    """Assert sharded == single-device flagship outputs over nblocks blocks,
    with a retune at block 3 and a channel-table grow at block 6. The
    single-device engine runs on the mesh's first device. Channel counts
    round up to multiples of D.

    Raises AssertionError on any mismatch; returns the largest differences
    seen (audio over its bound, N0 and sweep relative) and the geometry."""
    from ..runtime import Engine
    from ..runtime.engine import migrate_state

    D = mesh.size
    dev = mesh.devices[0]
    rup = lambda n: -(-n // D) * D  # noqa: E731
    n_hf, n_sweep = rup(n_hf), rup(n_sweep)
    groups = _flagship_groups(FS, n_hf, n_sweep)

    eng_s = Engine(samprate=FS, real=True, groups=groups, device=dev)
    eng_m = Engine(samprate=FS, real=True, groups=groups, mesh=mesh)
    L = eng_s.L

    # deterministic scene: noise and two carriers inside hf channels 7 and 500
    rng = np.random.default_rng(42)
    hf = np.linspace(0.02 * FS, 0.48 * FS, n_hf)
    f7 = float(hf[7]) + 700.0
    f500 = float(hf[min(500, n_hf - 1)]) + 1500.0

    def mkblock(k: int) -> torch.Tensor:
        t = (k * L + np.arange(L)) / FS
        x = rng.normal(size=L).astype(np.float32) * 1e-3
        x += (0.05 * np.cos(2 * np.pi * f7 * t) + 0.05 * np.cos(2 * np.pi * f500 * t)
              ).astype(np.float32)
        return torch.from_numpy(x).to(dev)

    ss, sm = eng_s.init_state(), eng_m.init_state()
    ps, pm = eng_s.init_params(), eng_m.init_params()
    worst = {"audio_err_over_bound": 0.0, "n0_rel": 0.0, "sweep_rel": 0.0}
    for k in range(nblocks):
        if k == 3:
            # mid-stream retune: rows written in place, nothing rebuilt
            before = (eng_s, eng_m, params_ptrs(ps), params_ptrs(pm))
            ps = eng_s.retune(ps, "hf", 7, f500 - 1500.0)
            pm = eng_m.retune(pm, "hf", 7, f500 - 1500.0)
            after = (eng_s, eng_m, params_ptrs(ps), params_ptrs(pm))
            assert all(a is b if i < 2 else a == b
                       for i, (a, b) in enumerate(zip(before, after))), \
                "a retune made new tensors or a new engine"
        if k == 6:
            # mid-stream dynamic create: grow the hf group by D slots (the
            # daemon's rebuild path), carrying state and host params
            def grow(eng, mesh_arg):
                specs = [dataclasses.replace(g, channels=g.channels + (g.channels[-1],) * D)
                         if g.name == "hf" else g for g in eng.specs]
                return Engine(samprate=FS, real=True, groups=specs,
                              **({"mesh": mesh_arg} if mesh_arg is not None else {"device": dev}))

            eng_s2, eng_m2 = grow(eng_s, None), grow(eng_m, mesh)
            ss = migrate_state(ss, eng_s2.init_state())
            sm = migrate_state(sm, eng_m2.init_state())
            ps = eng_s2.adopt_host_params(eng_s)
            pm = eng_m2.adopt_host_params(eng_m)
            eng_s, eng_m = eng_s2, eng_m2
        blk = mkblock(k)
        ss, out_s = eng_s.step(ss, ps, blk)
        sm, out_m = eng_m.step(sm, pm, blk)
        if k < 2:
            continue  # master warm-up
        a_s = out_s["hf"]["audio"].cpu().numpy()
        a_m = out_m["hf"]["audio"].cpu().numpy()
        scale = max(float(np.max(np.abs(a_s))), 1e-6)
        np.testing.assert_allclose(a_m, a_s, rtol=rtol, atol=atol * scale,
                                   err_msg=f"hf audio, block {k}")
        worst["audio_err_over_bound"] = max(worst["audio_err_over_bound"], float(np.max(
            np.abs(a_m - a_s) / (atol * scale + rtol * np.abs(a_s)))))
        # the N0 quantile is a discontinuous order statistic: the two
        # masters' different FFT factorizations (six-step against one cuFFT
        # transform) can pick adjacent bins near the threshold on a few
        # channels; 2% = 0.09 dB, an order below the 0.4 dB reference budget
        n0_s = out_s["hf"]["info"]["n0"].cpu().numpy()
        n0_m = out_m["hf"]["info"]["n0"].cpu().numpy()
        np.testing.assert_allclose(n0_m, n0_s, rtol=2e-2, err_msg=f"n0, block {k}")
        worst["n0_rel"] = max(worst["n0_rel"], float(np.max(
            np.abs(n0_m - n0_s) / np.maximum(np.abs(n0_s), 1e-30))))
        b_s = out_s["sweep"]["info"]["bin_data"].cpu().numpy()
        b_m = out_m["sweep"]["info"]["bin_data"].cpu().numpy()
        np.testing.assert_allclose(b_m, b_s, rtol=2e-2, atol=1e-12,
                                   err_msg=f"sweep bins, block {k}")
        worst["sweep_rel"] = max(worst["sweep_rel"], float(np.max(
            np.abs(b_m - b_s) / np.maximum(np.abs(b_s), 1e-30))))
    return {"D": D, "FS": FS, "N": eng_m.master.N, "split": [eng_m.digit.n1, eng_m.digit.n2],
            "digit_cols": eng_m.digit_cols, "C_hf": eng_m.groups["hf"].C,
            "C_sweep": eng_m.groups["sweep"].C, "blocks": nblocks, **worst}


def dryrun_multichip(n_devices: int, devices=None, nblocks: int = 7, n_hf: int = 1000) -> dict:
    """The sharded serving step over an n_devices mesh at the flagship
    geometry (BASELINE config #5: 129.6 Msps real master, the rof3240000
    transform, 1,000 SSB channels and a spectrum sweep): flagship_parity
    over nblocks blocks (the retune and the grow), then one time-sharded
    pass (Engine(time_shards=D): two dispatches of D blocks and an in-place
    retune). Where the flagship N does not split over the mesh it falls back
    to FS 2,048,000 and says so. It prints its geometry line first.

    devices: the mesh's devices (default: every local CUDA device, which
    must number n_devices)."""
    from ..runtime import Engine
    from .master import DigitMaster

    mesh = make_mesh(devices)
    if mesh.size != n_devices:
        raise ValueError(f"{mesh.size} devices for a mesh of {n_devices}")
    FS, geom = FLAGSHIP_FS, "FLAGSHIP"
    try:  # the flagship N = 3,240,000 splits for meshes up to 12
        dm = DigitMaster.plan(mesh, "c", int(round(FS * 0.02 * 1.25)))
    except ValueError as e:
        FS, geom = FALLBACK_FS, "FALLBACK"
        print(f"dryrun: flagship N does not split on D={n_devices} ({e}); "
              f"falling back to FS={FS:,.0f}", flush=True)
        dm = DigitMaster.plan(mesh, "c", int(round(FS * 0.02 * 1.25)))
    print(f"dryrun geometry: {geom} FS={FS:,.0f} N={dm.n1 * dm.n2:,} split={dm.n1}x{dm.n2} "
          f"D={n_devices} devices={[str(d) for d in mesh.devices]}", flush=True)

    par = flagship_parity(mesh, nblocks=nblocks, n_hf=n_hf, FS=FS)
    print(f"dryrun pass 1 OK: sharded==single parity, {nblocks} blocks, "
          f"retune@3 + table-grow@6, FS={FS:,.0f}", flush=True)

    # time-sharded mode: D consecutive blocks a dispatch, halo-exchanged
    # masters; a dispatch, an in-place retune, another dispatch
    def rup(n):
        return -(-n // n_devices) * n_devices

    eng = Engine(samprate=FS, real=True, mesh=mesh, time_shards=n_devices,
                 groups=_flagship_groups(FS, rup(200), rup(16)))
    state, params = eng.init_state(), eng.init_params()
    blocks = torch.zeros((n_devices, eng.L), dtype=torch.float32, device=mesh.devices[0])
    state, out = eng.step_time(state, params, blocks)
    ptrs = params_ptrs(params)
    params = eng.retune(params, "hf", 7, 0.25 * FS)
    assert params_ptrs(params) == ptrs, "time-sharded retune made new tensors"
    state, out = eng.step_time(state, params, blocks)
    for name, g in out.items():
        if not name.startswith("_"):
            assert bool(torch.isfinite(g["audio"]).all()), name
            assert g["audio"].shape[0] == n_devices, name
    print(f"dryrun pass 2 OK: time_shards={n_devices} FS={FS:,.0f} "
          f"groups={{hf: {rup(200)}, sweep: {rup(16)}}} 2 dispatches "
          f"({2 * n_devices} blocks), retune in place", flush=True)
    return {"geometry": geom, **par}
