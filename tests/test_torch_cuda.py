"""PyTorch port on the card: each CUDA kernel against its plain version (the
channelizer, the N0 estimator, the PLL and Goertzel recurrences and the
linear tail), and the small slices on CUDA against the same slices on the
CPU.

These need an NVIDIA GPU with the CUDA toolkit (the kernels build with nvcc
at first use); elsewhere they skip. On such a host:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""
import numpy as np
import pytest
import torch

from ka9q_radio_tpu_torch.ops import cuda_channelize as tcc
from ka9q_radio_tpu_torch.ops import filterbank as tfb
from ka9q_radio_tpu_torch.ops import noise as tnz
from ka9q_radio_tpu_torch.ops.filter_design import design_bandpass_response

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _ladder(real_master: bool, C: int = 256, seed: int = 0, n_bins: int = 256, olen: int = 200,
            master_N: int = 65_536):
    rng = np.random.default_rng(seed)
    m_bins = master_N // 2 + 1 if real_master else master_N
    r = design_bandpass_response(n_bins, olen, 50 / 12e3, 3e3 / 12e3, 11.0, real_master, master_N)
    resp = (r[None, :] * np.exp(1j * rng.uniform(0, 2 * np.pi, (C, 1)))).astype(np.complex64)
    shifts = (np.linspace(-8000, 20_000, C) if real_master
              else np.linspace(-30_000, 30_000, C)).astype(np.int32)
    rt, tl, sl = tfb.build_tile_params(resp, shifts, real_master, master_N)
    E = tfb.tiled_idft_matrix(n_bins, olen, rt.shape[-1])
    F = (rng.standard_normal(m_bins) + 1j * rng.standard_normal(m_bins)).astype(np.complex64)
    return (F, rt, tl, sl, shifts, E), (n_bins, olen, real_master, master_N)


@pytest.mark.parametrize("real_master", [True, False])
def test_channelize_kernel_matches_plain(cuda, real_master):
    arrays, geo = _ladder(real_master)
    args = [torch.as_tensor(a, device=cuda) for a in arrays]
    op = tcc.channelize_operand(args[5], geo[0], geo[1])
    n = tcc.launches["channelize"]
    got = tcc.cuda_channelize(*args, *geo, E_op=op)
    want = tfb.tiled_channelize(*args, *geo)
    torch.cuda.synchronize()
    assert tcc.launches["channelize"] == n + 1
    assert float((got - want).abs().max()) < 3e-5 * float(want.abs().max())


@pytest.mark.parametrize("real_master", [True, False])
def test_noise_kernel_matches_plain(cuda, real_master):
    (F, _, _, _, shifts, _), (_, _, _, master_N) = _ladder(real_master)
    F, shifts = torch.as_tensor(F, device=cuda), torch.as_tensor(shifts, device=cuda)
    n0_k, keys_k = tcc.cuda_noise_est(F, shifts, 1000, real_master, master_N, 1e6)
    m_bins = master_N // 2 + 1 if real_master else master_N
    n0_t, keys_t = tnz.estimate_noise_keys(
        tnz.gather_noise_bins(F, shifts, 1000, real_master, master_N), m_bins, 1e6)
    torch.cuda.synchronize()
    assert torch.equal(keys_k, keys_t)
    torch.testing.assert_close(n0_k, n0_t, rtol=2e-5, atol=0)


@pytest.mark.parametrize("real_master", [True, False])
@pytest.mark.parametrize("n_bins,olen,C", [(100, 80, 256), (301, 241, 256), (300, 240, 257),
                                            (600, 480, 100), (1200, 960, 40), (1400, 1120, 40),
                                            (2100, 1680, 24)])
def test_channelize_kernel_geometries(cuda, real_master, n_bins, olen, C):
    """A frame more than twice the slice (S = 256 > 2 n: the fold adds three
    terms), an odd n, C = 257 (no multiple of any row tile), slices wide
    enough that a CTA holds 32 and 16 channels, and slices too wide for a
    whole 16-row X tile (n > 1280: the kernel takes it in two K segments),
    up to about the widest the engine puts on this path; two launches give
    the same bits."""
    arrays, geo = _ladder(real_master, C=C, seed=n_bins, n_bins=n_bins, olen=olen)
    args = [torch.as_tensor(a, device=cuda) for a in arrays]
    op = tcc.channelize_operand(args[5], n_bins, olen)
    got = tcc.cuda_channelize(*args, *geo, E_op=op)
    again = tcc.cuda_channelize(*args, *geo, E_op=op)
    want = tfb.tiled_channelize(*args, *geo)
    torch.cuda.synchronize()
    assert got.shape == (C, olen) and torch.equal(got, again)
    assert float((got - want).abs().max()) < 3e-5 * float(want.abs().max())


def _crossover(n_bins: int, olen: int, device) -> int:
    """The fewest channels (whole row tiles) that channelize_plan puts on
    kernel A's persistent design on this card."""
    sms, n_pad = tcc.sm_count(device), tcc.fold_pad(n_bins)
    C = 64
    while tcc.channelize_plan(C, n_pad, olen, sms) != "persistent":
        C += 64
        assert C < 1_000_000, "the plan never takes the persistent design at this shape"
    return C


# (real master, C or an offset from the crossover, n, olen, inputs, design forced or None for
# channelize_plan's, master points)
_DESIGN_CASES = {
    "below_crossover": (True, -64, 300, 240, False, None, 3_240_000),
    "at_crossover": (True, 0, 300, 240, False, None, 3_240_000),
    "ragged_above": (True, 37, 300, 240, False, None, 3_240_000),
    "flagship_real": (True, 32_728, 300, 240, False, None, 3_240_000),
    "flagship_complex": (False, 32_728, 300, 240, False, None, 65_536),
    "ragged_small_forced": (True, 257, 300, 240, False, "persistent", 65_536),
    "one_tile_forced": (False, 12, 300, 240, False, "persistent", 65_536),
    "odd_slice_forced": (True, 1_000, 301, 241, False, "persistent", 65_536),
    "short_frame_forced": (False, 700, 100, 80, False, "persistent", 65_536),
    "inputs": (True, 3_000, 300, 240, True, None, 65_536),
    "inputs_complex_forced": (False, 96, 300, 240, True, "persistent", 65_536),
    "n600": (True, 4_000, 600, 480, False, None, 3_240_000),
}


@pytest.mark.parametrize("case", list(_DESIGN_CASES))
def test_channelize_designs(cuda, case):
    """Kernel A's persistent design, where channelize_plan picks it and where
    a case forces it, and the one-shot design beside it: C on both sides of
    the plan's crossover and ragged above it, the flagship's 32,728 channels
    on a real and on a complex master, a C that fills neither a row tile nor
    the card's SMs, one row tile, an odd slice, a frame more than twice the slice,
    channels on three inputs, n 600 / olen 480 (whose X tile does not fit:
    the plan keeps it one-shot). Real masters carry inverted slices. Each
    within 3e-5 of the plain version's peak, two launches bit-equal, and a
    CUDA graph's replay equal to the eager call."""
    real_master, C, n_bins, olen, multi, forced, master_N = _DESIGN_CASES[case]
    if case in ("below_crossover", "at_crossover", "ragged_above"):
        C += _crossover(n_bins, olen, cuda)
    if multi:
        arrays, geo, inputs = _multi_ladder(real_master, C=C, seed=C)
        inp = torch.as_tensor(inputs, device=cuda)
    else:
        arrays, geo = _ladder(real_master, C=C, seed=C + n_bins, n_bins=n_bins, olen=olen,
                              master_N=master_N)
        inp = None
    F, rt, tl, sl, shifts, E = [torch.as_tensor(a, device=cuda) for a in arrays]
    n_bins, olen, real_master, master_N = geo
    op = tcc.channelize_operand(E, n_bins, olen)
    plan = tcc.channelize_plan(C, tcc.fold_pad(n_bins), olen, tcc.sm_count(cuda))
    design = forced or plan
    assert plan == {"below_crossover": "one-shot", "n600": "one-shot"}.get(case, plan)
    if case in ("at_crossover", "ragged_above", "flagship_real", "flagship_complex", "inputs"):
        assert plan == "persistent"
    m_bins = master_N // 2 + 1 if real_master else master_N
    ld = F.shape[1] if multi else 0

    def call():
        if forced is None:
            return tcc.cuda_channelize(F, rt, tl, sl, shifts, E, *geo, E_op=op, inputs=inp)
        out = torch.empty((C, olen), dtype=torch.complex64, device=cuda)
        tcc._launch_channelize(F, rt, tl, sl, shifts, E, op, out, n_bins, real_master, m_bins,
                               ld, inp, design == "persistent")
        return out

    got, again = call(), call()
    want = tfb.tiled_channelize(F, rt, tl, sl, shifts, E, *geo, inputs=inp)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = call()
    graph.replay()
    torch.cuda.synchronize()
    assert got.shape == (C, olen) and torch.equal(got, again)
    assert torch.equal(replayed, got)
    assert float((got - want).abs().max()) < 3e-5 * float(want.abs().max())


@pytest.mark.parametrize("W", [128, 1024, 4096])
def test_noise_kernel_windows(cuda, W):
    """W = 128 (registers, 4 keys a lane), 1024 (32) and 4096 (shared
    memory), C = 257, with an all-zero window, a window of equal energies
    and one of heavy ties: keys exact, N0 within rtol 2e-5."""
    rng = np.random.default_rng(W)
    master_N = 131_072
    m_bins = master_N // 2 + 1
    F = (rng.standard_normal(m_bins) + 1j * rng.standard_normal(m_bins)).astype(np.complex64)
    F[: 2 * W] = 0.0  # channel 0's window
    F[8 * W: 10 * W] = np.complex64(0.3 + 0.4j)  # channel 1's
    F[12 * W: 14 * W] = np.round(F[12 * W: 14 * W] * 4) / 4  # ties
    shifts = np.linspace(W, m_bins - W, 257).astype(np.int32)
    shifts[:3] = [W // 2, 9 * W, -13 * W]
    F, shifts = torch.as_tensor(F, device=cuda), torch.as_tensor(shifts, device=cuda)
    n0_k, keys_k = tcc.cuda_noise_est(F, shifts, W, True, master_N, 1e6)
    energies = tnz.gather_noise_bins(F, shifts, W, True, master_N)
    n0_t, keys_t = tnz.estimate_noise_keys(energies, m_bins, 1e6)
    torch.cuda.synchronize()
    assert int(energies[0].count_nonzero()) == 0 and bool((energies[1] == energies[1, 0]).all())
    assert torch.equal(keys_k, keys_t)
    assert float(n0_k[0]) == 0.0
    torch.testing.assert_close(n0_k, n0_t, rtol=2e-5, atol=0)


def test_wrappers_refuse_bad_tensors(cuda):
    arrays, geo = _ladder(True, C=8)
    args = [torch.as_tensor(a, device=cuda) for a in arrays]
    args[1] = args[1].T.contiguous().T  # a non-contiguous response table
    with pytest.raises(ValueError, match="contiguous"):
        tcc.cuda_channelize(*args, *geo)
    args = [torch.as_tensor(a, device=cuda) for a in arrays]
    args[2] = args[2].long()
    with pytest.raises(TypeError, match="dtype"):
        tcc.cuda_channelize(*args, *geo)
    args = [torch.as_tensor(a, device=cuda) for a in arrays]
    with pytest.raises(ValueError, match="E_op"):  # the kernel's operand is the caller's
        tcc.cuda_channelize(*args, *geo)


def test_small_slice_on_card_matches_cpu(cuda):
    """The small slice of test_torch_engine on the card (kernels) and on the
    CPU (plain versions), six blocks from the same start."""
    import ka9q_radio_tpu_torch.runtime as trt

    fs = 2_048_000
    freqs = np.linspace(0.05 * fs, 0.45 * fs, 64)

    def groups():
        return [trt.GroupSpec(name="hf", demod="linear", samprate=8_000, snr_squelch=True,
                              channels=tuple(trt.ChannelSpec(freq=float(f), low=50.0, high=3000.0)
                                             for f in freqs)),
                trt.GroupSpec(name="sweep", demod="spectrum", samprate=32_400, bin_bw=1000.0,
                              bin_count=32, channels=(trt.ChannelSpec(freq=5e5),))]

    eg, ec = trt.Engine(fs, groups(), device=cuda), trt.Engine(fs, groups(), device="cpu")
    sg, pg, sc, pc = eg.init_state(), eg.init_params(), ec.init_state(), ec.init_params()
    rng = np.random.default_rng(5)
    tcc.reset_launches()
    for b in range(6):
        t = np.arange(b * eg.L, (b + 1) * eg.L) / fs
        x = (0.01 * rng.standard_normal(eg.L) + 0.2 * np.cos(2 * np.pi * (freqs[9] + 700) * t)
             ).astype(np.float32)
        sg, og = eg.step(sg, pg, torch.as_tensor(x, device=cuda))
        sc, oc = ec.step(sc, pc, torch.from_numpy(x))
        a_g, a_c = og["hf"]["audio"].cpu(), oc["hf"]["audio"]
        assert float((a_g - a_c).abs().max()) < 5e-4 * float(a_c.abs().max())
    assert tcc.launches == {"channelize": 6, "noise_est": 3, "pll_scan": 0, "goertzel": 0,
                            "linear_tail": 6}


_DAEMON_CONF = """
[global]
hardware = sig_gen
mode = usb
update = 3
{extra}
[sig_gen]
device = sig_gen
samprate = 1m024
real = {real}
carrier = 60k7
[hf]
mode = usb
samprate = 12k
raster = 40k 120k 10k
snr-squelch = yes
"""


@pytest.mark.parametrize("extra,real", [("", "no"), ("big-group = 4\negress-slots = 4", "yes"),
                                        ("time-shards = 2", "yes")],
                         ids=["complex", "big-group-egress", "time-shards"])
def test_radiod_on_cuda_matches_cpu(cuda, extra, real):
    """The daemon on the card against the daemon on the CPU, the same numpy
    blocks through step_block: RTP headers equal and samples within 1 LSB,
    the same beacons, and the kernels launched on every block."""
    from ka9q_radio_tpu_torch.config import load_config
    from ka9q_radio_tpu_torch.net.rtp import RtpHeader
    from ka9q_radio_tpu_torch.runtime.radiod import Radiod

    conf = _DAEMON_CONF.format(extra=extra, real=real)
    rc = Radiod(load_config(conf), use_network=False, device="cuda")
    rh = Radiod(load_config(conf), use_network=False, device="cpu")
    D = rc._time_shards or 1
    rng = np.random.default_rng(9)
    L = rc.engine.L
    tcc.reset_launches()
    for b in range(12 // D):
        n = np.arange(b * D * L, (b + 1) * D * L) / 1_024_000
        x = 0.1 * np.exp(2j * np.pi * 60_700 * n) + 1e-3 * (rng.standard_normal(n.size)
                                                              + 1j * rng.standard_normal(n.size))
        x = (x.real if real == "yes" else x).astype(np.float32 if real == "yes" else np.complex64)
        x = x.reshape(D, L) if D > 1 else x
        rc.step_block(block=x)
        rh.step_block(block=x)
    assert tcc.launches["channelize"] == 12
    assert [k for k, _ in rc._sent] == [k for k, _ in rh._sent]
    assert any(k == "data" for k, _ in rc._sent)
    for (kind, a), (_, b) in zip(rc._sent, rh._sent):
        if kind != "data":
            continue
        ha, pa = RtpHeader.unpack(a)
        hb, pb = RtpHeader.unpack(b)
        assert (ha.ssrc, ha.seq, ha.timestamp, ha.type, ha.marker) == \
            (hb.ssrc, hb.seq, hb.timestamp, hb.type, hb.marker)
        d = np.frombuffer(pa, ">i2").astype(np.int32) - np.frombuffer(pb, ">i2").astype(np.int32)
        assert np.abs(d).max(initial=0) <= 1


def test_pll_after_isb_on_cuda_matches_cpu(cuda):
    """ISB, then the PLL, on the carrier's channel: a filter2 class whose
    second stage leaves the block a column slice, which the PLL kernel's
    wrapper refuses; the demodulator hands it whole rows, the card's
    daemon captures the class's graphs, and its samples are the CPU
    daemon's within 2e-3 of the peak (the PLL's bound in
    test_every_demod_on_card_matches_cpu), the PLL kernel launched every
    block."""
    from ka9q_radio_tpu_torch.config import load_config
    from ka9q_radio_tpu_torch.net.rtp import RtpHeader
    from ka9q_radio_tpu_torch.net.status import StatusType as T, encode_status
    from ka9q_radio_tpu_torch.runtime.radiod import Radiod

    conf = _DAEMON_CONF.format(extra="", real="no")
    rc = Radiod(load_config(conf), use_network=False, device="cuda")
    rh = Radiod(load_config(conf), use_network=False, device="cpu")
    rng = np.random.default_rng(10)
    L = rc.engine.L

    def step(b):
        n = np.arange(b * L, (b + 1) * L) / 1_024_000
        x = (0.1 * np.exp(2j * np.pi * 60_700 * n)
             + 1e-3 * (rng.standard_normal(n.size) + 1j * rng.standard_normal(n.size)))
        for rd in (rc, rh):
            rd.step_block(block=x.astype(np.complex64))

    step(0)
    for b, fields in enumerate(({T.INDEPENDENT_SIDEBAND: True, T.RADIO_FREQUENCY: 60_700.0},
                                {T.PLL_ENABLE: True, T.PLL_BW: 25.0})):
        pkt = encode_status({T.OUTPUT_SSRC: 60, **fields}, cmd=True)
        for rd in (rc, rh):
            rd.handle_packet(pkt)
        step(1 + b)
    spec = rc.engine.groups[rc.chans[60].group].spec
    assert spec.isb and spec.enable_pll and spec.filter2 >= 1
    tcc.reset_launches()
    for b in range(3, 9):
        step(b)
    assert tcc.launches["pll_scan"] == 6
    assert rc.graph_stats()["current"]["replays"] >= 5
    assert [k for k, _ in rc._sent] == [k for k, _ in rh._sent]
    for (kind, a), (_, b) in zip(rc._sent, rh._sent):
        if kind != "data":
            continue
        (ha, pa), (hb, pb) = RtpHeader.unpack(a), RtpHeader.unpack(b)
        assert (ha.ssrc, ha.seq, ha.timestamp, ha.type) == (hb.ssrc, hb.seq, hb.timestamp, hb.type)
        xa, xb = (np.frombuffer(p, ">i2").astype(np.float64) for p in (pa, pb))
        assert np.abs(xa - xb).max(initial=0) <= max(2e-3 * np.abs(xb).max(initial=0), 1.0)


def test_radiod_rebuild_and_restock_on_cuda(cuda):
    """Dynamic creates on the card: a foreground table rebuild, then a
    background restock whose engine is built on a side stream and swapped
    in at a block boundary. The packets match the CPU daemon's doing the
    same, and the swapped-in tables live on the card."""
    from ka9q_radio_tpu_torch.config import load_config
    from ka9q_radio_tpu_torch.net.rtp import RtpHeader
    from ka9q_radio_tpu_torch.net.status import StatusType as T, encode_status
    from ka9q_radio_tpu_torch.runtime.radiod import Radiod

    conf = _DAEMON_CONF.format(extra="dyn-slots = 2", real="no")
    rds = [Radiod(load_config(conf), use_network=False, device=d) for d in ("cuda", "cpu")]
    rng = np.random.default_rng(10)
    L = rds[0].engine.L

    def step(n):
        for _ in range(n):
            t = np.arange(rds[0].blocks * L, (rds[0].blocks + 1) * L) / 1_024_000
            x = (0.1 * np.exp(2j * np.pi * 60_700 * t) + 1e-3 * (
                rng.standard_normal(L) + 1j * rng.standard_normal(L))).astype(np.complex64)
            for rd in rds:
                rd.step_block(block=x)

    for rd in rds:
        rd._pool_need = lambda gname: 0  # size restocks by dyn-slots alone
    step(3)
    for ssrc, f in ((9999, 60_000.0), (8888, 50_000.0)):
        for rd in rds:
            rd.handle_packet(encode_status({T.OUTPUT_SSRC: ssrc, T.PRESET: "lsb",
                                            T.RADIO_FREQUENCY: f}, cmd=True))
        step(1)
    for rd in rds:
        rd._finish_restock(wait=True)
    g = rds[0].chans[9999].group
    assert rds[0].engine.groups[g].C == rds[1].engine.groups[g].C == 5
    assert rds[0].params[g]["shifts"].is_cuda and rds[0].state["groups"][g]["dc"]["n0"].is_cuda
    step(4)
    a, b = rds[0]._sent, rds[1]._sent
    assert [k for k, _ in a] == [k for k, _ in b]
    for (kind, pa), (_, pb) in zip(a, b):
        if kind == "data":
            ha, xa = RtpHeader.unpack(pa)
            hb, xb = RtpHeader.unpack(pb)
            assert (ha.ssrc, ha.seq, ha.timestamp, ha.marker) == (hb.ssrc, hb.seq, hb.timestamp,
                                                                  hb.marker)
            d = np.frombuffer(xa, ">i2").astype(np.int32) - np.frombuffer(xb, ">i2").astype(np.int32)
            assert np.abs(d).max(initial=0) <= 1


def test_noise_kernel_wfm_window(cuda):
    """The 9,600-bin WFM slice's window (W = 9,600, keys in shared memory)
    on a complex 7.68 Msps master, mod-wrapped through DC: keys exact."""
    rng = np.random.default_rng(11)
    master_N = 192_000
    F = (rng.standard_normal(master_N) + 1j * rng.standard_normal(master_N)).astype(np.complex64)
    shifts = np.array([0, 4000, -4000, 60_000, -95_000, 95_999, 25_000, -30_000], np.int32)
    F, shifts = torch.as_tensor(F, device=cuda), torch.as_tensor(shifts, device=cuda)
    n0_k, keys_k = tcc.cuda_noise_est(F, shifts, 9_600, False, master_N, 7.68e6)
    n0_t, keys_t = tnz.estimate_noise_keys(
        tnz.gather_noise_bins(F, shifts, 9_600, False, master_N), master_N, 7.68e6)
    torch.cuda.synchronize()
    assert torch.equal(keys_k, keys_t)
    torch.testing.assert_close(n0_k, n0_t, rtol=2e-5, atol=0)


def _pll_inputs(C: int, T: int, device, seed: int = 12):
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 12_000
    amp = np.logspace(-3, -0.5, C)[:, None]
    bb = amp * np.exp(2j * np.pi * (rng.uniform(-20, 20, (C, 1)) * t + rng.uniform(0, 1, (C, 1))))
    bb = (bb + 3e-4 * (rng.standard_normal((C, T)) + 1j * rng.standard_normal((C, T))))
    d = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    pll = {"vco_phase": d(rng.integers(-2**31, 2**31, C, dtype=np.int64).astype(np.int32)),
           "u": d(rng.uniform(-1e-3, 1e-3, C).astype(np.float32)),
           "phi": d(rng.uniform(-0.9, 0.9, C).astype(np.float32)),
           "wraps": d(rng.integers(-3, 3, C).astype(np.int32))}
    from ka9q_radio_tpu_torch.ops.osc import pll_params

    k1, k2 = pll_params(d(np.full(C, 20.0 / 12_000, np.float32)))
    return (d(bb.astype(np.complex64)), pll, k1, k2, d(np.arange(C) % 3 == 0),
            d(np.arange(C) % 2 == 1))


def test_pll_scan_kernel_matches_plain(cuda):
    """C = 400, T = 240 (the SAM shapes), locked and unlocked, plain and
    squared detectors: the kernel against its plain loop on the card. Both
    round each operation once in the same order, so they agree to a few ulp
    of the mixed samples and VCO words within 4,096 LSB (1e-6 rev) on the
    carrier-led channels; launches are counted."""
    from ka9q_radio_tpu_torch.models.linear import pll_scan_plain
    from ka9q_radio_tpu_torch.ops.cuda_recur import cuda_pll_scan

    args = _pll_inputs(400, 240, cuda)
    n = tcc.launches["pll_scan"]
    mk, sk, gk, nk = cuda_pll_scan(*args)
    mp, sp, gp, np_ = pll_scan_plain(*args)
    torch.cuda.synchronize()
    assert tcc.launches["pll_scan"] == n + 1
    assert float((mk - mp).abs().max()) <= 1e-5 * float(mp.abs().max())
    dv = (sk["vco_phase"].long() - sp["vco_phase"].long() + 2**31) % 2**32 - 2**31
    assert int(dv.abs().max()) <= 4096
    torch.testing.assert_close(gk, gp, rtol=1e-5, atol=0)
    torch.testing.assert_close(nk, np_, rtol=1e-5, atol=0)
    assert torch.equal(sk["wraps"], sp["wraps"])


def test_goertzel_kernel_matches_plain(cuda):
    """C = 400, T = 480 (the nbfm400 shapes): the kernel against its plain
    loop on the card, within 1e-5 of the state's peak."""
    from ka9q_radio_tpu_torch.ops.cuda_recur import cuda_goertzel_block
    from ka9q_radio_tpu_torch.ops.iir import goertzel_coeff, goertzel_update_block

    rng = np.random.default_rng(13)
    C, T = 400, 480
    x = torch.as_tensor(rng.standard_normal((C, T)).astype(np.float32), device=cuda)
    coeff, _ = goertzel_coeff(torch.as_tensor(rng.uniform(60, 260, C).astype(np.float32) / 24_000,
                                              device=cuda))
    st = {"s0": torch.as_tensor(rng.standard_normal(C).astype(np.float32), device=cuda),
          "s1": torch.as_tensor(rng.standard_normal(C).astype(np.float32), device=cuda)}
    n = tcc.launches["goertzel"]
    got = cuda_goertzel_block(st, x, coeff)
    want = goertzel_update_block(st, x, coeff)
    torch.cuda.synchronize()
    assert tcc.launches["goertzel"] == n + 1
    for k in ("s0", "s1"):
        assert float((got[k] - want[k]).abs().max()) <= 1e-5 * float(want[k].abs().max())


def test_every_demod_on_card_matches_cpu(cuda):
    """test_torch_engine's every-demodulator slice on the card and on the
    CPU, six blocks from the same start: each group's audio within 5e-4 of
    its peak (the WFM composite and the PLL within 2e-3, chaotic detectors
    as test_torch_demods says), and each kernel launched."""
    import ka9q_radio_tpu_torch.runtime as trt
    from torch_scenes import CFS, demod_block, demod_groups

    eg = trt.Engine(CFS, demod_groups(trt), real=False, device=cuda)
    ec = trt.Engine(CFS, demod_groups(trt), real=False, device="cpu")
    sg, pg, sc, pc = eg.init_state(), eg.init_params(), ec.init_state(), ec.init_params()
    rng = np.random.default_rng(14)
    tcc.reset_launches()
    for b in range(6):
        x = demod_block(b, eg.L, rng)
        sg, og = eg.step(sg, pg, torch.as_tensor(x, device=cuda))
        sc, oc = ec.step(sc, pc, torch.from_numpy(x))
        if b < 2:
            continue
        for name in ec.groups:
            a_g, a_c = og[name]["audio"].cpu(), oc[name]["audio"]
            if a_c.numel():
                tol = 2e-3 if name in ("wfm", "sam") else 5e-4
                assert float((a_g - a_c).abs().max()) <= tol * float(a_c.abs().max()), (b, name)
    assert tcc.launches["pll_scan"] == 6 and tcc.launches["goertzel"] == 6
    assert tcc.launches["channelize"] == 6 * (len(ec.groups) - 1)  # WFM: FFT-IDFT on cuFFT


def _multi_ladder(real_master: bool, B: int = 3, C: int = 96, seed: int = 15):
    """B spectra in the engine's padded layout ([B, ld], ld whole 128-bin
    tiles: an odd real master's rows, 32,769 bins, would otherwise start 8
    bytes off on every odd input), tile params of C channels over all of
    them, slices clamped at DC and Nyquist or wrapped through DC."""
    rng = np.random.default_rng(seed)
    master_N, n_bins, olen = 65_536, 300, 240
    m_bins = master_N // 2 + 1 if real_master else master_N
    ld = -(-m_bins // 128) * 128
    r = design_bandpass_response(n_bins, olen, 50 / 12e3, 3e3 / 12e3, 11.0, real_master, master_N)
    resp = (r[None, :] * np.exp(1j * rng.uniform(0, 2 * np.pi, (C, 1)))).astype(np.complex64)
    lim = m_bins - 1 if real_master else master_N // 2
    shifts = rng.integers(-lim, lim, C).astype(np.int32)
    shifts[:4] = [0, 5, lim - 3, -lim + 2]
    inputs = (np.arange(C) % B).astype(np.int32)
    F = np.zeros((B, ld), np.complex64)
    F[:, :m_bins] = rng.standard_normal((B, m_bins)) + 1j * rng.standard_normal((B, m_bins))
    F[:, m_bins:] = 1e3  # the pad: no kernel may read it
    rt, tl, sl = tfb.build_tile_params(resp, shifts, real_master, master_N)
    E = tfb.tiled_idft_matrix(n_bins, olen, rt.shape[-1])
    return (F, rt, tl, sl, shifts, E), (n_bins, olen, real_master, master_N), inputs


@pytest.mark.parametrize("real_master", [True, False])
def test_kernels_with_inputs_match_plain(cuda, real_master):
    """Kernels A and B with per-channel inputs on three padded rows (an odd
    real master, and a complex one): A within 3e-5 of its peak, B's keys
    exact and N0 within rtol 2e-5 against their plain versions; the rows
    [B, m_bins] of an odd master are refused (their odd rows are not
    16-byte aligned)."""
    arrays, geo, inputs = _multi_ladder(real_master)
    args = [torch.as_tensor(a, device=cuda) for a in arrays]
    inp = torch.as_tensor(inputs, device=cuda)
    op = tcc.channelize_operand(args[5], geo[0], geo[1])
    got = tcc.cuda_channelize(*args, *geo, E_op=op, inputs=inp)
    want = tfb.tiled_channelize(*args, *geo, inputs=inp)
    F, shifts, master_N = args[0], args[4], geo[3]
    n0_k, keys_k = tcc.cuda_noise_est(F, shifts, 1000, real_master, master_N, 1e6, inputs=inp)
    m_bins = master_N // 2 + 1 if real_master else master_N
    n0_t, keys_t = tnz.estimate_noise_keys(
        tnz.gather_noise_bins(F, shifts, 1000, real_master, master_N, inp), m_bins, 1e6)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) < 3e-5 * float(want.abs().max())
    assert torch.equal(keys_k, keys_t)
    torch.testing.assert_close(n0_k, n0_t, rtol=2e-5, atol=0)
    if real_master:
        with pytest.raises(ValueError, match="even"):
            tcc.cuda_noise_est(F[:, :m_bins].contiguous(), shifts, 1000, True, master_N, 1e6,
                               inputs=inp)


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("real_master,master_N,nbins", [
    (False, 60_000, 1000), (False, 60_000, 1024), (False, 60_000, 700), (False, 4_800, 1000),
    (False, 300, 1000), (True, 1_800, 1000), (True, 1_200, 700)])
def test_noise_kernel_per_element_windows(cuda, real_master, master_N, nbins, multi):
    """Kernel B on per-element windows (small or odd masters): starts off
    the 128-bin grid, lengths that are not whole tiles (the lanes past them
    masked), windows wrapped through DC and longer than the master, one
    spectrum or three padded rows: keys exact, N0 within rtol 2e-5."""
    rng = np.random.default_rng(master_N + nbins + multi)
    B = 3 if multi else 1
    m_bins = master_N // 2 + 1 if real_master else master_N
    ld = -(-m_bins // 128) * 128
    F = np.full((B, ld), np.complex64(1e3))
    F[:, :m_bins] = ((rng.standard_normal((B, m_bins)) + 1j * rng.standard_normal((B, m_bins)))
                     * rng.uniform(0.1, 10.0, (B, m_bins)))
    lim = m_bins - 1 if real_master else master_N // 2
    shifts = np.concatenate([np.linspace(-lim, lim, 61), [0, 1, -1, 7, 65]]).astype(np.int32)
    Fd = torch.as_tensor(F if multi else F[0, :m_bins], device=cuda)
    sh = torch.as_tensor(shifts, device=cuda)
    inp = torch.as_tensor((np.arange(shifts.size) % B).astype(np.int32), device=cuda) if multi else None
    assert not tnz.noise_window_fits(nbins, real_master, master_N)
    n = tcc.launches["noise_est"]
    n0_k, keys_k = tcc.cuda_noise_est(Fd, sh, nbins, real_master, master_N, 2.4e6, inputs=inp)
    n0_t, keys_t = tnz.estimate_noise_keys(
        tnz.gather_noise_bins(Fd, sh, nbins, real_master, master_N, inp), m_bins, 2.4e6)
    torch.cuda.synchronize()
    assert tcc.launches["noise_est"] == n + 1
    assert torch.equal(keys_k, keys_t)
    torch.testing.assert_close(n0_k, n0_t, rtol=2e-5, atol=0)


def test_two_input_daemon_on_cuda_matches_cpu(cuda):
    """The two-sig_gen daemon of tests/test_torch_multife.py on the card and
    on the CPU, the same [2, L] numpy blocks: RTP headers equal and samples
    within 1 LSB, and both kernels launched with their inputs."""
    from ka9q_radio_tpu_torch.config import load_config
    from ka9q_radio_tpu_torch.net.rtp import RtpHeader
    from ka9q_radio_tpu_torch.runtime.radiod import Radiod
    from torch_scenes import TWO_FE, two_fe_blocks

    conf = TWO_FE.format(opts="")
    rc = Radiod(load_config(conf), use_network=False, device="cuda")
    rh = Radiod(load_config(conf), use_network=False, device="cpu")
    tcc.reset_launches()
    for x in two_fe_blocks(12, rc.engine.L, 5):
        rc.step_block(block=x)
        rh.step_block(block=x)
    assert tcc.launches["channelize"] == 12 * 3 and tcc.launches["noise_est"] > 0
    assert [k for k, _ in rc._sent] == [k for k, _ in rh._sent]
    assert any(k == "data" for k, _ in rc._sent)
    for (kind, a), (_, b) in zip(rc._sent, rh._sent):
        if kind != "data":
            continue
        ha, pa = RtpHeader.unpack(a)
        hb, pb = RtpHeader.unpack(b)
        assert (ha.ssrc, ha.seq, ha.timestamp, ha.type, ha.marker) == \
            (hb.ssrc, hb.seq, hb.timestamp, hb.type, hb.marker)
        d = np.frombuffer(pa, ">i2").astype(np.int32) - np.frombuffer(pb, ">i2").astype(np.int32)
        assert np.abs(d).max(initial=0) <= 1
    np.testing.assert_allclose(rc.if_power_in, rh.if_power_in, rtol=1e-5)


def test_per_shard_kernels_on_card(cuda):
    """On a card: kernels A and B on each of 4 shards of cuda:0 (local C/4
    rows of the all-gathered spectrum) against their plain versions, at the
    tolerances of tests/test_torch_cuda.py (A < 3e-5 of the peak; B's keys
    exact, N0 rtol 2e-5), and one launch of each a shard and a block."""
    import ka9q_radio_tpu_torch.runtime as trt
    from ka9q_radio_tpu_torch.ops import cuda_channelize as cc
    from ka9q_radio_tpu_torch.ops.filterbank import tiled_channelize
    from ka9q_radio_tpu_torch.ops.noise import estimate_noise_keys, gather_noise_bins
    from ka9q_radio_tpu_torch.parallel import make_mesh
    from ka9q_radio_tpu_torch.parallel.sharding import local_tree

    FSK = 2_048_000
    freqs = np.linspace(0.05 * FSK, 0.45 * FSK, 512)
    mesh = make_mesh([torch.device("cuda", 0)] * 4)
    em = trt.Engine(samprate=FSK, real=True, mesh=mesh, groups=[trt.GroupSpec(
        name="hf", demod="linear", samprate=8_000,
        channels=tuple(trt.ChannelSpec(freq=float(f), low=50.0, high=2_700.0) for f in freqs))])
    g, m, p = em.groups["hf"], em.master, em.init_params()["hf"]
    F = torch.randn(m.bins, dtype=torch.complex64, device="cuda")
    for d in range(4):
        lp = local_tree(p, d)
        got = cc.cuda_channelize(F, lp["resp_tiles"], lp["tile_lo"], lp["slope"], lp["shifts"],
                                 g.lcs[d]["tile_E"], g.n_bins, g.olen, m.real, m.N,
                                 E_op=g.lcs[d]["tile_op"])
        want = tiled_channelize(F, lp["resp_tiles"], lp["tile_lo"], lp["slope"], lp["shifts"],
                                g.lcs[d]["tile_E"], g.n_bins, g.olen, m.real, m.N)
        assert got.shape == (128, g.olen)
        assert float((got - want).abs().max()) < 3e-5 * float(want.abs().max())
        n0, keys = cc.cuda_noise_est(F, lp["shifts"], g.noise_bins, m.real, m.N, em.samprate)
        n0_t, keys_t = estimate_noise_keys(
            gather_noise_bins(F, lp["shifts"], g.noise_bins, m.real, m.N), m.bins, em.samprate)
        assert torch.equal(keys, keys_t)
        assert float(((n0 - n0_t).abs() / n0_t.abs()).max()) <= 2e-5
    cc.reset_launches()
    st = em.init_state()
    st, out = em.step(st, em.init_params(), torch.randn(em.L, device="cuda"))
    torch.cuda.synchronize()
    assert cc.launches["channelize"] == 4 and cc.launches["noise_est"] == 4
    assert bool(torch.isfinite(out["hf"]["audio"]).all())


# -- the compiled dispatch (runtime/graphs.py) --------------------------------
def _graph_engine(config: str, device):
    """bench.py's configurations (bench_torch.build_engine), an RTL-SDR's
    odd master and the 2 m daemon's kinds (NBFM with CTCSS, SAM), on the
    card: (engine, blocks maker n -> [n, ...] on the card)."""
    import sys
    from pathlib import Path

    import ka9q_radio_tpu_torch.runtime as trt
    from torch_scenes import demod_groups, odd_master_groups

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import bench_torch

    if config == "odd_master":
        eng = trt.Engine(samprate=2_400_000, real=False,
                         groups=odd_master_groups(trt, 2_400_000), device=device)
    elif config == "2m":
        eng = trt.Engine(samprate=1_024_000, real=False, device=device,
                         groups=[g for g in demod_groups(trt) if g.name in ("fm", "sam")])
    else:
        eng = bench_torch.build_engine(config, device=device)[0]
    gen = torch.Generator(device=device).manual_seed(31)
    shape = (eng.L,) if eng.n_inputs == 1 else (eng.n_inputs, eng.L)

    def blocks(n):
        if eng.master.real:
            return 1e-3 * torch.randn((n,) + shape, generator=gen, device=device)
        return 1e-3 * torch.complex(torch.randn((n,) + shape, generator=gen, device=device),
                                    torch.randn((n,) + shape, generator=gen, device=device))

    return eng, blocks


def _trees_equal(a, b, where) -> None:
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _trees_equal(a[k], b[k], f"{where}/{k}")
    elif torch.is_tensor(a):
        assert a.shape == b.shape and a.dtype == b.dtype, where
        assert torch.equal(a, b), where
    else:
        assert a == b, where


@pytest.mark.parametrize("config,D", [("rx888", 0), ("rx888", 4), ("rx888x4", 0),
                                      ("nbfm400", 0), ("wfm", 0), ("odd_master", 0),
                                      ("2m", 0), ("2m", 3)])
def test_graph_replay_equals_eager_step(cuda, config, D):
    """12 blocks (D a dispatch with time shards) through GraphStep and
    through the eager step from the same state and params, with a retune
    after a third of them and the sweep disarmed for a dispatch where the
    config has one: outputs, carried state and host mirrors bit for bit
    (the replays run exactly the eager step's kernels), and the launch
    counters equal."""
    from ka9q_radio_tpu_torch.runtime.graphs import GraphStep

    eng, blocks = _graph_engine(config, cuda)
    gs = GraphStep(eng, D)
    p = eng.init_params()
    se, sg = eng.init_state(), eng.init_state()
    n = 12 // max(D, 1)
    xs = blocks(12).reshape((n, D) + tuple(blocks(1).shape[1:])) if D else blocks(12)
    first = next(iter(eng.groups))
    got = {"eager": dict.fromkeys(tcc.launches, 0), "graph": dict.fromkeys(tcc.launches, 0)}
    for b in range(n):
        if b == n // 3:
            g = eng.groups[first]
            eng.retune(p, first, 0, float(g.spec.channels[0].freq) + 500.0)
        if "sweep" in eng.groups and b in (n // 2, n // 2 + 1):
            eng.set_armed(p, "sweep", b != n // 2)
        for name, run in (("eager", lambda: gs.eager(se, p, xs[b])), ("graph", lambda: gs(sg, p, xs[b]))):
            tcc.reset_launches()
            st, out = run()
            torch.cuda.synchronize()
            for k, v in tcc.launches.items():
                got[name][k] += v
            if name == "eager":
                se, oe = st, out
            else:
                sg, og = st, out
        assert sg["host"] == se["host"], b
        _trees_equal(og, oe, f"{config} block {b} out")
        _trees_equal({k: v for k, v in sg.items() if k != "host"},
                     {k: v for k, v in se.items() if k != "host"}, f"{config} block {b} state")
    assert got["graph"] == got["eager"], got
    stats = gs.graph_stats()
    assert stats["dispatch"] == "cuda graph" and stats["replays"] >= n - 2, stats
    assert all(g["pool_bytes"] is None or g["pool_bytes"] > 0 for g in stats["graphs"].values())


@pytest.mark.parametrize("D,time_shards", [(2, False), (4, False), (4, True)])
def test_mesh_graph_replay_equals_eager_step(cuda, D, time_shards):
    """A mesh of D shards of the one card ([cuda:0] * D) through GraphStep
    and through its eager step from the same state and params: the
    channel-sharded Engine.step (12 blocks) or step_time (6 dispatches of
    D), a retune and the sweep disarmed for a dispatch; outputs, the carried
    state made whole and host mirrors bit for bit, the launch counters
    equal (A D times a block, or once a block of a dispatch of D), every
    dispatch after the sweep's warm-up a replay."""
    import ka9q_radio_tpu_torch.runtime as trt
    from ka9q_radio_tpu_torch.parallel import make_mesh
    from ka9q_radio_tpu_torch.parallel.sharding import full_tree
    from ka9q_radio_tpu_torch.runtime.graphs import GraphStep

    fs = 2_048_000
    dev = torch.device("cuda", 0)
    groups = [
        trt.GroupSpec(name="hf", demod="linear", samprate=8_000, snr_squelch=True,
                      channels=tuple(trt.ChannelSpec(freq=float(f), low=50.0, high=3000.0)
                                     for f in np.linspace(0.05 * fs, 0.45 * fs, 8))),
        trt.GroupSpec(name="sweep", demod="spectrum", samprate=32_400, bin_bw=1000.0,
                      bin_count=32, channels=tuple(trt.ChannelSpec(freq=float(f))
                                                   for f in np.linspace(0.1, 0.4, 4) * fs))]
    eng = trt.Engine(samprate=fs, real=True, groups=groups, spurs=[0.3 * fs],
                     mesh=make_mesh([dev] * D), time_shards=D if time_shards else 0)
    Dd = D if time_shards else 0
    gs = GraphStep(eng, Dd)
    p = eng.init_params()
    se, sg = eng.init_state(), eng.init_state()
    n = 6 if time_shards else 12
    gen = torch.Generator(device=dev).manual_seed(32)
    xs = 1e-3 * torch.randn((n,) + ((D,) if Dd else ()) + (eng.L,), generator=gen, device=dev)
    got = {"eager": dict.fromkeys(tcc.launches, 0), "graph": dict.fromkeys(tcc.launches, 0)}
    for b in range(n):
        if b == n // 3:
            eng.retune(p, "hf", 0, float(groups[0].channels[0].freq) + 500.0)
        if b in (n // 2, n // 2 + 1):
            eng.set_armed(p, "sweep", b != n // 2)
        for name, run in (("eager", lambda: gs.eager(se, p, xs[b])), ("graph", lambda: gs(sg, p, xs[b]))):
            tcc.reset_launches()
            st, out = run()
            torch.cuda.synchronize()
            for k, v in tcc.launches.items():
                got[name][k] += v
            if name == "eager":
                se, oe = st, out
            else:
                sg, og = st, out
        assert sg["host"] == se["host"], b
        _trees_equal(og, oe, f"mesh D={D} block {b} out")
        _trees_equal(full_tree({k: v for k, v in sg.items() if k != "host"}),
                     full_tree({k: v for k, v in se.items() if k != "host"}),
                     f"mesh D={D} block {b} state")
    assert got["graph"] == got["eager"] and got["graph"]["channelize"] == D * n, got
    stats = gs.graph_stats()
    eager = sum(stats["eager_blocks"].values())
    assert stats["dispatch"] == "cuda graph" and stats["replays"] * max(Dd, 1) + eager == \
        n * max(Dd, 1), stats
    assert set(stats["eager_blocks"]) <= {"sweep: spectrum warm-up (frame weights 1/(n+1))"}


def test_example_daemon_captures_repeat(cuda, tmp_path):
    """examples/radiod@hf-generic.conf's daemon (four groups, an NBFM one
    among them) built 60 times on the card, each capturing its graphs at
    init and dispatching a block: every capture goes through. The capture
    of this daemon's first branch was invalidated now and then
    (cudaErrorStreamCaptureInvalidated) when a full cyclic collection ran
    inside it and finalized the daemons built before; GraphStep holds the
    collector off while it captures (runtime/graphs.py _gc_held)."""
    import sys
    from pathlib import Path

    from ka9q_radio_tpu_torch.config import load_config
    from ka9q_radio_tpu_torch.runtime.radiod import Radiod

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    text, _ = chip_smoke.example_config("hf-generic", tmp_path, 2)
    for _ in range(60):
        rd = Radiod(load_config(text), use_network=False)
        rd.step_block()
        rd.frontend.close()
        assert rd.graph_stats()["current"]["captures"] >= 1
    torch.cuda.synchronize()


def test_graph_capture_that_cannot_work_raises(cuda):
    """A branch that reads a device value back to the host (.item()) cannot
    be captured: GraphStep raises, naming the call, and the eager step and
    later captures still work on the card."""
    from ka9q_radio_tpu_torch.runtime.graphs import GraphStep

    eng, blocks = _graph_engine("linear8", cuda)
    g = eng.groups["lin"]
    noise = g._noise_est

    def syncing(params, F, d=0):
        n0 = noise(params, F, d)
        return n0 * float(n0.sum().item() >= 0.0)

    g._noise_est = syncing
    gs = GraphStep(eng)
    st, p = eng.init_state(), eng.init_params()
    with pytest.raises(RuntimeError, match="capturing the step's branch 'W' failed in .*item"):
        gs(st, p, blocks(1)[0])
    g._noise_est = noise
    st, out = eng.step(st, p, blocks(1)[0])
    st, out = GraphStep(eng)(st, p, blocks(1)[0])
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out["lin"]["audio"]).all())


# -- the linear tail (csrc/linear_tail.cu) --------------------------------------
_AGC_BRANCHES = ("peak", "strong", "noise", "hang", "recover")


def _tail_rows(C: int, N: int, device, seed: int) -> tuple:
    """Mixed rows of a linear tail's inputs: tones of 1e-3 to 1 with noise,
    one row in five with a 6x burst in one 2 ms sub-block; each row's gain,
    N0 and hang drawn so that every AGC branch, squelch state and
    transition occurs; the AGC, the CW shift and the SNR squelch each on
    about half the rows. Returns (bb, acc, inc, adj, n0, state, params) on
    device."""
    from ka9q_radio_tpu_torch.models.linear import linear_init

    rng = np.random.default_rng(seed)
    amp = 10.0 ** rng.uniform(-3, 0, (C, 1))
    t = np.arange(N)
    bb = amp * np.exp(1j * (rng.uniform(0, 2 * np.pi, (C, 1)) + rng.uniform(-1, 1, (C, 1)) * t))
    bb += 0.1 * amp * (rng.standard_normal((C, N)) + 1j * rng.standard_normal((C, N)))
    burst = rng.random(C) < 0.2
    s0 = rng.integers(0, N // 24, C) * 24
    for c in np.nonzero(burst)[0]:
        bb[c, s0[c]:s0[c] + 24] *= 6.0
    headroom, threshold, bw = np.float32(0.178), np.float32(0.178), np.float32(2950.0)
    g_rel = 10.0 ** rng.uniform(-1.5, 0.7, C)  # gain x amplitude over headroom
    gain = g_rel * headroom / amp[:, 0]
    bn_rel = 10.0 ** rng.uniform(-1.2, 1.2, C)  # noise amplitude x gain over threshold x headroom
    n0 = (bn_rel * threshold * headroom / gain) ** 2 / bw
    i32 = lambda n: rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)  # noqa: E731
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    i = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=device)  # noqa: E731
    b = lambda a: torch.as_tensor(np.asarray(a, bool), device=device)  # noqa: E731
    st = linear_init(C, device=device)
    st["agc"] = {"gain": f(gain), "hangcount": i(np.where(rng.random(C) < 0.5, 0,
                                                          rng.integers(1, 30_000, C)))}
    st["shift_acc"], st["am_dc"] = i(i32(C)), f(rng.uniform(-1, 1, C))
    st["squelch_state"], st["squelch_open"] = i(rng.integers(0, 7, C)), b(rng.random(C) < 0.5)
    params = {"agc_enable": b(rng.random(C) < 0.6), "headroom": f(np.full(C, headroom)),
              "hangtime_samples": i(np.full(C, 13_200)),
              "recovery_per_sample": f(np.full(C, 1.00048)),
              "threshold": f(np.full(C, threshold)), "bandwidth": f(np.full(C, bw)),
              "manual_gain": f(10.0 ** rng.uniform(0, 3, C)),
              "shift_inc_q32": i(np.where(rng.random(C) < 0.5, 0, i32(C))),
              "squelch_open": f(np.full(C, 6.31)), "squelch_close": f(np.full(C, 5.01)),
              "squelch_tail": i(rng.integers(0, 3, C)),
              "snr_squelch_enable": b(rng.random(C) < 0.5)}
    return (torch.as_tensor(bb.astype(np.complex64), device=device), i(i32(C)), i(i32(C)),
            i(i32(C)), f(n0), st, params)


def _tail_decisions(bb, acc, inc, adj, n0, st, p, blocktime: float = 0.02) -> dict:
    """The plain chain's AGC branch (-1 with the AGC off) and squelch inputs
    of each row, whether any of its decisions lies within 1e-4 of its
    threshold (a knife edge, where float32 sums in another order may go
    either way), and on the strong and noisy branches its gain_change (the
    block's N-th root, agc_block's gc_strong or gc_noise; NaN elsewhere)."""
    from ka9q_radio_tpu_torch.ops.filterbank import fine_tune
    from ka9q_radio_tpu_torch.ops.osc import phase_ramp_q32

    N = bb.shape[1]
    x, _ = fine_tune(bb, acc, inc, adj)
    bb_power = (x.real * x.real + x.imag * x.imag).mean(-1)
    ramp, _ = phase_ramp_q32(st["shift_acc"], p["shift_inc_q32"], N)
    x = torch.where((p["shift_inc_q32"] != 0)[:, None], x * ramp, x)
    sps = int(round(N * 0.002 / blocktime))
    pw = (x.real * x.real + x.imag * x.imag)[:, : (N // sps) * sps]
    peak = torch.sqrt(pw.reshape(len(pw), -1, sps).mean(-1).amax(-1))
    g, h, t = st["agc"]["gain"], p["headroom"], p["threshold"]
    bn = torch.sqrt(p["bandwidth"] * torch.clamp(n0, min=0.0))
    ratios = [peak * g / (1.4142135 * h), torch.sqrt(bb_power) * g / h, bn * g / (t * h)]
    over = [r > 1 for r in ratios]
    branch = torch.where(over[0], 0, torch.where(over[1], 1, torch.where(
        over[2], 2, torch.where(st["agc"]["hangcount"] > 0, 3, 4))))
    branch = torch.where(p["agc_enable"], branch, -1)
    inv_n, eps = float(np.float32(1.0 / N)), float(np.float32(1e-30))
    gc_strong = torch.pow(torch.clamp(h / (torch.sqrt(bb_power) * g + eps), min=eps), inv_n)
    gc_noise = torch.pow(torch.clamp(t * h / (bn * g + eps), min=eps), inv_n)
    gc = torch.where(branch == 1, gc_strong, torch.where(branch == 2, gc_noise, float("nan")))
    edge = torch.zeros_like(p["agc_enable"])
    for r in ratios:
        edge |= p["agc_enable"] & ((r - 1).abs() < 1e-4)
    snr = bb_power / torch.clamp(n0 * p["bandwidth"], min=1e-30) - 1.0
    for thr in (p["squelch_open"], p["squelch_close"]):
        edge |= p["snr_squelch_enable"] & ((snr / thr - 1).abs() < 1e-4)
    return {"branch": branch.cpu().numpy(), "edge": edge.cpu().numpy(),
            "snr": snr.cpu().numpy(), "gc": gc}


def _tail_against_plain(args, blocktime: float = 0.02, samprate: int = 12_000) -> dict:
    """The kernel and its plain version on the same inputs on the card,
    compared: audio within 1e-5 of the plain row's peak, the NCO words
    equal, the powers, the SNR's ratio and gain within 1e-5, every
    decision equal, on the rows off the knife edges (where either branch is
    accepted); a row whose gain_change rounds to the neighbouring float32
    is held to the chain's outputs on that neighbour. Returns the plain
    chain's decisions (_tail_decisions)."""
    from ka9q_radio_tpu_torch.ops.cuda_tail import cuda_linear_tail, linear_tail_plain

    kw = dict(samprate=samprate, blocktime=blocktime)
    n = tcc.launches["linear_tail"]
    acc_k, pw_k, st_k, audio_k, info_k = cuda_linear_tail(*args, **kw)
    acc_p, pw_p, st_p, audio_p, info_p = linear_tail_plain(*args, **kw)
    torch.cuda.synchronize()
    assert tcc.launches["linear_tail"] == n + 1
    dec = _tail_decisions(*args, blocktime=blocktime)
    off = torch.as_tensor(~dec["edge"], device=audio_k.device)
    assert torch.equal(acc_k, acc_p) and torch.equal(st_k["shift_acc"], st_p["shift_acc"])
    for tree_k, tree_p in ((st_k, st_p), (info_k, info_p)):
        assert list(tree_k) == list(tree_p)
        for k in tree_p:
            a, b = tree_k[k], tree_p[k]
            if isinstance(b, dict):
                assert list(a) == list(b), k
                continue
            assert a.shape == b.shape and a.dtype == b.dtype, k
    torch.testing.assert_close(pw_k[off], pw_p[off], rtol=1e-5, atol=0)
    # audio within 1e-5 of the row's peak, output_power and the new gain
    # within 1e-5. The strong and noisy branches raise gain_change, a
    # rounded N-th root, to the i-th power along the ramp and to the N-th
    # for the new gain: where the kernel's root rounds to the neighbouring
    # float32 (its bb_power summed in another order), that one step (6e-8)
    # grows N-fold (1.4e-5 at N 240). Such a row is held to the chain's
    # outputs with that neighbour in place of gain_change, and at most one
    # row in 1,000 may be one.
    g0, gc, N = args[5]["agc"]["gain"], dec["gc"], audio_p.shape[1]
    i = torch.arange(N, dtype=torch.float32, device=audio_p.device)
    ramp_p = g0[:, None] * torch.exp(i[None, :] * torch.log(gc)[:, None])
    peak = audio_p.abs().amax(-1, keepdim=True)

    def rows_ok(audio, opow, gain):
        return (((audio_k - audio).abs() <= 1e-5 * peak).all(-1)
                & ((info_k["output_power"] - opow).abs() <= 1e-5 * opow.abs())
                & ((st_k["agc"]["gain"] - gain).abs() <= 1e-5 * gain.abs()))

    ok = rows_ok(audio_p, info_p["output_power"], st_p["agc"]["gain"])
    on_step = torch.zeros_like(ok)
    for to in (0.0, 2.0):
        nb = torch.nextafter(gc, torch.full_like(gc, to))
        ramp = g0[:, None] * torch.exp(i[None, :] * torch.log(nb)[:, None])
        audio = (audio_p.double() * ramp.double() / ramp_p.double()).float()
        on_step |= ~ok & torch.isfinite(gc) & rows_ok(audio, 2.0 * (audio * audio).mean(-1),
                                                      g0 * torch.pow(nb, float(N)))
    assert bool((ok | on_step)[off].all())
    assert int(on_step.sum()) <= max(1, len(ok) // 1000), int(on_step.sum())
    # the SNR is a power ratio less 1: within 1e-5 of the ratio
    fin = off & torch.isfinite(info_p["snr"])
    sk, sp = info_k["snr"][fin], info_p["snr"][fin]
    assert bool(((sk - sp).abs() <= 1e-5 * (sp.abs() + 1)).all())
    assert torch.equal(torch.isinf(info_k["snr"]), torch.isinf(info_p["snr"]))
    for a, b in ((st_k["agc"]["hangcount"], st_p["agc"]["hangcount"]),
                 (st_k["squelch_state"], st_p["squelch_state"]),
                 (st_k["squelch_open"], st_p["squelch_open"]), (st_k["am_dc"], st_p["am_dc"]),
                 (info_k["send"], info_p["send"]), (info_k["pll_lock"], info_p["pll_lock"])):
        assert torch.equal(a[off], b[off])
    dec["open_before"] = args[5]["squelch_open"].cpu().numpy()
    dec["open_after"] = st_p["squelch_open"].cpu().numpy()
    dec["state_after"] = st_p["squelch_state"].cpu().numpy()
    return dec


def test_linear_tail_kernel_mixed_rows(cuda):
    """hf-farm's shapes (C 32,728 x N 240): the kernel against the plain
    chain on the card over rows that mix the AGC on and off, the CW shift on
    and off and the SNR squelch on and off, from every squelch state. Each
    of the five AGC branches (peak clamp, strong, noise, hang, recovery)
    and each squelch transition is reached, as asserted. Audio within 1e-5
    of the chain's row peak, acc_q32 and shift_acc equal, decisions equal
    off the thresholds: on an AGC or squelch knife edge (a ratio within
    1e-4 of its threshold) either branch is accepted, as the AGC parity
    tests accept either (test_agc_thresholds_same_branch)."""
    args = _tail_rows(32_728, 240, cuda, seed=25)
    dec = _tail_against_plain(args)
    sq_en = args[6]["snr_squelch_enable"].cpu().numpy()
    agc_on = args[6]["agc_enable"].cpu().numpy()
    shift_on = (args[6]["shift_inc_q32"] != 0).cpu().numpy()
    off = ~dec["edge"]
    branch = dec["branch"][off]
    counts = {name: int((branch == k).sum()) for k, name in enumerate(_AGC_BRANCHES)}
    counts["agc_off"] = int((branch == -1).sum())
    assert min(counts.values()) >= 20, counts
    for flags in (sq_en, agc_on, shift_on):
        assert 0.2 < flags.mean() < 0.8
    before = args[5]["squelch_state"].cpu().numpy()
    assert set(before[sq_en]) == set(range(7))
    o0, o1, s1, snr = dec["open_before"], dec["open_after"], dec["state_after"], dec["snr"]
    on = sq_en & off
    reached = {"opens": on & ~o0 & o1, "closes": on & o0 & ~o1, "stays open": on & o0 & o1,
               "tail counts down": on & (s1 == before - 1) & (s1 > 0),
               "between the thresholds": on & (snr < 6.31) & (snr >= 5.01),
               "no squelch": ~sq_en & o1 & (s1 == args[6]["squelch_tail"].cpu().numpy() + 4)}
    assert all(int(v.sum()) >= 5 for v in reached.values()), {k: int(v.sum())
                                                             for k, v in reached.items()}
    assert dec["edge"].mean() < 0.01


@pytest.mark.parametrize("C,agc", [(12, False), (10, True), (8, True)], ids=["wspr", "ft8", "ft4"])
def test_linear_tail_kernel_hf_generic(cuda, C, agc):
    """hf-generic's USB groups (WSPR x12 with the AGC off at 60 dB, FT8 x10
    and FT4 x8 with it on; N 240): the kernel against the plain chain on the
    card, three blocks carried, with the checks of the mixed-rows test."""
    args = list(_tail_rows(C, 240, cuda, seed=C))
    args[6]["agc_enable"].fill_(agc)
    args[6]["manual_gain"].fill_(1000.0)
    args[6]["snr_squelch_enable"].fill_(False)
    from ka9q_radio_tpu_torch.ops.cuda_tail import linear_tail_plain

    for _ in range(3):
        _tail_against_plain(tuple(args))
        acc, _, st, _, _ = linear_tail_plain(*args, samprate=12_000, blocktime=0.02)
        args[1], args[5] = acc, st


@pytest.mark.parametrize("N,blocktime", [(96, 0.008), (33, 0.02), (960, 0.02), (4800, 0.02),
                                         (8000, 0.02)])
def test_linear_tail_kernel_geometries(cuda, N, blocktime):
    """Other row lengths: short (96 at 8 ms blocks; 33, odd) and long (960:
    48 kHz; 4,800: 240 kHz, one row a CTA; 8,000: 400 kHz, a row past 48
    KB of shared memory), C 300."""
    _tail_against_plain(_tail_rows(300, N, cuda, seed=N), blocktime=blocktime,
                        samprate=int(round(N / blocktime)))


def test_linear_tail_kernel_row_stride(cuda):
    """The per-element channelizer's baseband, a column slice of its inverse
    FFT (rows 300 samples apart, 240 read): the kernel against the plain
    chain on the same slice."""
    bb, *rest = _tail_rows(64, 300, cuda, seed=7)
    _tail_against_plain((bb[:, 60:], *rest))


def test_linear_tail_wrapper_refuses_bad_tensors(cuda):
    from ka9q_radio_tpu_torch.ops.cuda_tail import cuda_linear_tail

    bb, acc, inc, adj, n0, st, p = _tail_rows(16, 240, cuda, seed=1)
    kw = dict(samprate=12_000, blocktime=0.02)
    with pytest.raises(TypeError, match="dtype"):
        cuda_linear_tail(bb, acc.long(), inc, adj, n0, st, p, **kw)
    with pytest.raises(ValueError, match="shape"):
        cuda_linear_tail(bb, acc, inc, adj, n0[:8], st, p, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_linear_tail(bb.T.contiguous().T, acc, inc, adj, n0, st, p, **kw)
    with pytest.raises(ValueError, match="expected cuda"):
        cuda_linear_tail(bb, acc, inc, adj, n0.cpu(), st, p, **kw)


def test_linear_tail_in_graph_replay(cuda):
    """bench.py's rx888 (1,000 usb channels with SNR squelch, the sweep)
    through GraphStep and through its eager step, 12 blocks from the same
    state: outputs and state bit for bit, and linear_tail launched once a
    block each way (the replays counted as the eager step's launches)."""
    from ka9q_radio_tpu_torch.runtime.graphs import GraphStep

    eng, blocks = _graph_engine("rx888", cuda)
    assert eng.groups["hf"].fused_tail and not eng.groups["sweep"].fused_tail
    gs = GraphStep(eng, 0)
    p = eng.init_params()
    se, sg = eng.init_state(), eng.init_state()
    xs = blocks(12)
    got = {}
    for name in ("eager", "graph"):
        tcc.reset_launches()
        for b in range(12):
            if name == "eager":
                se, oe = gs.eager(se, p, xs[b])
                got.setdefault("outs", []).append(oe)
            else:
                sg, og = gs(sg, p, xs[b])
                torch.cuda.synchronize()
                _trees_equal(og, got["outs"][b], f"block {b} out")
        torch.cuda.synchronize()
        got[name] = tcc.launches["linear_tail"]
    _trees_equal({k: v for k, v in sg.items() if k != "host"},
                 {k: v for k, v in se.items() if k != "host"}, "state")
    assert got["eager"] == got["graph"] == 12, got
    assert gs.graph_stats()["dispatch"] == "cuda graph"
