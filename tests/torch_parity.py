"""Holding the port to the JAX package on the CPU, shared by the port's
parity tests.

The engines block by block: both from the same params, and each of the
port's blocks started from the JAX engine's state (the AGC's and the
squelch's decisions can sit on their thresholds by construction, ROADMAP
Queue 3).

The daemons pairwise (`DaemonPair`): the JAX daemon and the port's on one
config, fed the same numpy blocks and the same command packets, and held to
each other on the wire packet for packet (`assert_same_wire`: each payload
by its encoding, each status field by its kind), on their channel tables,
free slots, host mirrors and params; with `dispatch="graph"` the port's
daemon dispatches through the emulated graph body (GraphStep with
emulate=True in the daemon's place, its rebuilds' and restocks' too)."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

import ka9q_radio_tpu_torch.runtime as trt
from ka9q_radio_tpu_torch.net.rtp import Encoding, RtpHeader
from ka9q_radio_tpu_torch.net.status import StatusType as T, decode_status, encode_status

# demodulator readouts compared at looser bounds elsewhere (the RDS
# baseband, the PLL's phase and offset: tests/test_torch_demods.py)
LOOSE = ("rds_baseband", "cphase", "foffset")


def tree_np(tree):
    if isinstance(tree, dict):
        return {k: tree_np(v) for k, v in tree.items()}
    return tree.numpy() if torch.is_tensor(tree) else np.asarray(tree)


def assert_same_tree(got, want, rtol=0.0, path=""):
    """Keys, dtypes and shapes equal; values equal (floats within rtol
    where it is given)."""
    assert sorted(got) == sorted(want), path
    for k in want:
        if isinstance(want[k], dict):
            assert_same_tree(got[k], want[k], rtol, f"{path}/{k}")
            continue
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, f"{path}/{k}"
        if rtol == 0.0 or w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=f"{path}/{k}")
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=0, err_msg=f"{path}/{k}")


def assert_outputs_close(to, jo, rtol: float = 2e-4, audio_rtol: float = 5e-4, where=""):
    """Every group's audio within audio_rtol of its peak, its info floats
    within rtol of their largest value, flags and counters exact; the
    front end's per-input IF power within 1e-5."""
    for name, j in jo.items():
        if name == "_frontend":
            np.testing.assert_allclose(to[name]["if_power"].numpy(), j["if_power"], rtol=1e-5)
            continue
        ja, ta = j["audio"], to[name]["audio"].numpy()
        assert ta.shape == ja.shape, (where, name)
        if ja.size:
            assert np.abs(ta - ja).max() <= audio_rtol * max(np.abs(ja).max(), 1e-30), (where, name)
        ji, ti = j["info"], to[name]["info"]
        assert sorted(ti) == sorted(ji), (where, name)
        for k, w in ji.items():
            g = ti[k].numpy()
            if w.dtype.kind in "biu":
                np.testing.assert_array_equal(g, w, err_msg=f"{where} {name}/{k}")
            elif k not in LOOSE:
                fin = np.isfinite(w)
                assert np.abs(g[fin] - w[fin]).max(initial=0) <= rtol * max(
                    np.abs(w[fin]).max(initial=0), 1e-30), (where, name, k)


def step_against_jax(je, te, blocks, skip: int = 2):
    """blocks (numpy, [n, L] or [n, B, L]) through both engines from the JAX
    engine's params, each port block from the JAX engine's state; outputs
    compared from block `skip` on (the master's turn-on before it).
    Returns the last (port outputs, JAX outputs)."""
    jp, js = je.init_params(), je.init_state()
    tp = trt.params_from_jax(jax.device_get(jp), device="cpu")
    assert_same_tree(tree_np(te.init_params()), jax.device_get(jp))
    step = jax.jit(je.step)
    for b, x in enumerate(blocks):
        ts = trt.state_from_jax(jax.device_get(js), device="cpu")
        js, jo = step(js, jp, jnp.asarray(x))
        ts, to = te.step(ts, tp, torch.from_numpy(np.ascontiguousarray(x)))
        jo = jax.device_get(jo)
        if b >= skip:
            assert_outputs_close(to, jo, where=f"block {b}")
    return to, jo


# ------------------------------------------------------- the daemons pairwise
FS = 1_024_000  # the sample rate of every pairwise config's complex master
UNTIMED = {T.GPS_TIME, T.TP1}  # wall clock and block time: not a function of the input

# (rtol, atol) of the demodulators' readouts where 2e-5 cannot hold: the
# frequency offsets are means over a block, zero up to rounding here, which
# the packages sum in another order (1e-3 Hz); the CTCSS deviation is read
# off the Goertzel resonator, which XLA runs with a contracted multiply-add
# (test_torch_demods holds it to 1e-3); the PLL's phase and offset follow
# its VCO word, held there to 1e-6 rev; the FM SNR goes through i0e/i1e,
# whose torch and XLA versions differ by a few ulp (1e-3 dB); the peak
# deviation is the largest of a block's discriminator outputs, each an atan2
# that the two libraries round apart (1e-4)
FIELD_TOL = {T.FREQ_OFFSET: (2e-5, 1e-3), T.PL_DEVIATION: (1e-3, 0.0),
             T.PLL_PHASE: (0.0, 1e-5), T.FM_SNR: (0.0, 1e-3),
             T.PEAK_DEVIATION: (1e-4, 0.0)}

# status fields that carry a measured power (or a gain) in dB: compared as
# the linear power 10^(dB/10) at rtol 2e-5, so that a value near 0 dB
# (OUTPUT_LEVEL after GAIN = 20, say) is held as tightly as any other
DB_FIELDS = {T.IF_POWER, T.BASEBAND_POWER, T.NOISE_DENSITY, T.OUTPUT_LEVEL, T.GAIN,
             T.PLL_SNR}

# payload bounds by encoding: a float sample within one s16 LSB of full
# scale (what the s16 bound admits of the floats it was quantized from), a
# half float within 2 ulp (WFM's RDS companion, test_torch_radiod)
F32_ATOL = 2.0 ** -15
F16_ULP = 2


def assert_same_fields(pj: bytes, pt: bytes, skip=()):
    """Two status packets field for field: the same type, fields and
    integers; floats per FIELD_TOL, else rtol 2e-5 (dB fields as linear
    powers), lists (BIN_DATA) rtol 2e-5; UNTIMED and `skip` left out."""
    kj, fj, rj = decode_status(pj)
    kt, ft, rt = decode_status(pt)
    assert kj == kt and rj == rt
    assert set(fj) == set(ft), set(fj) ^ set(ft)
    for k in fj:
        if k in UNTIMED or k in skip:
            continue
        a, b = fj[k], ft[k]
        if isinstance(a, float) and k in DB_FIELDS:
            np.testing.assert_allclose(10.0 ** (b / 10.0), 10.0 ** (a / 10.0), rtol=2e-5,
                                       atol=0.0, err_msg=k.name)
        elif isinstance(a, float):
            rtol, atol = FIELD_TOL.get(k, (2e-5, 1e-12))
            np.testing.assert_allclose(b, a, rtol=rtol, atol=atol, err_msg=k.name)
        elif isinstance(a, list):
            # BIN_DATA: a bin's rounding follows the master FFT's largest
            # bins, not its own, so bins are held as the engine parity
            # holds info leaves (assert_outputs_close): within 2e-4 of the
            # largest
            w = np.asarray(a, np.float64)
            assert np.abs(np.asarray(b) - w).max(initial=0) <= 2e-4 * np.abs(w).max(initial=0), \
                k.name
        else:
            assert a == b, (k.name, a, b)


def assert_same_payload(enc: Encoding, aj: bytes, at: bytes, what=""):
    """Two RTP payloads of one encoding: s16 within 1 LSB, F32 within one
    s16 LSB of full scale, F16 within 2 ulp, mu-law and A-law exact, Opus
    by its TOC byte (assert_same_wire decodes the streams)."""
    if enc not in (Encoding.OPUS, Encoding.OPUS_VOIP):
        assert len(aj) == len(at), (what, len(aj), len(at))
    if enc in (Encoding.S16BE, Encoding.S16LE):
        dt = ">i2" if enc == Encoding.S16BE else "<i2"
        d = np.frombuffer(aj, dt).astype(np.int32) - np.frombuffer(at, dt).astype(np.int32)
        assert np.abs(d).max(initial=0) <= 1, (what, np.abs(d).max())
    elif enc in (Encoding.F32LE, Encoding.F32BE):
        dt = "<f4" if enc == Encoding.F32LE else ">f4"
        a, b = np.frombuffer(aj, dt), np.frombuffer(at, dt)
        assert np.all(np.isfinite(a) == np.isfinite(b)), what
        assert np.abs(a - b).max(initial=0) <= F32_ATOL, (what, np.abs(a - b).max())
    elif enc in (Encoding.F16LE, Encoding.F16BE):
        dt = "<f2" if enc == Encoding.F16LE else ">f2"
        a, b = (np.frombuffer(x, dt).astype(np.float64) for x in (aj, at))
        assert np.all(np.abs(a - b) <= F16_ULP * 2.0**-10 * np.maximum(np.abs(a), 2.0**-14)), what
    elif enc in (Encoding.MULAW, Encoding.ALAW):
        assert aj == at, what
    elif enc in (Encoding.OPUS, Encoding.OPUS_VOIP):
        assert aj[:1] == at[:1], what  # the TOC byte: mode, bandwidth, frame size
    else:
        raise AssertionError(f"{what}: no comparison for {enc!r}")


def assert_same_wire(jsent: list, tsent: list, registry, skip=()):
    """The two daemons' packets, in order: RTP headers equal and each
    payload by the encoding its payload type has in `registry` (the port
    daemon's; the types are equal by the headers); status packets by
    assert_same_fields (`skip`: fields the caller compares itself). An
    Opus encoder's VBR byte count follows the last
    bits of its input (payloads 53 and 58 bytes long from PCM within 1
    LSB), so each Opus stream is decoded (libopus) and the two held to the
    same frames a packet and a correlation of at least 0.99."""
    assert [k for k, _ in jsent] == [k for k, _ in tsent]
    opus: dict = {}
    for i, ((kind, pj), (_, pt)) in enumerate(zip(jsent, tsent)):
        if kind == "status":
            assert_same_fields(pj, pt, skip)
            continue
        hj, aj = RtpHeader.unpack(pj)
        ht, at = RtpHeader.unpack(pt)
        assert (hj.ssrc, hj.seq, hj.timestamp, hj.type, hj.marker) == \
            (ht.ssrc, ht.seq, ht.timestamp, ht.type, ht.marker), i
        enc = registry.table[hj.type][2]
        assert_same_payload(enc, aj, at, f"packet {i} ssrc {hj.ssrc}")
        if enc in (Encoding.OPUS, Encoding.OPUS_VOIP):
            opus.setdefault(hj.ssrc, []).append((aj, at))
    for ssrc, pkts in opus.items():
        from ka9q_radio_tpu_torch.net.opus import OpusDecoder

        dj, dt = OpusDecoder(), OpusDecoder()
        a, b = [], []
        for pj, pt in pkts:
            a.append(dj.decode(pj))
            b.append(dt.decode(pt))
            assert a[-1].shape == b[-1].shape, ssrc
        a, b = np.concatenate(a).ravel(), np.concatenate(b).ravel()
        assert np.corrcoef(a, b)[0, 1] >= 0.99, (ssrc, np.corrcoef(a, b)[0, 1])


def chan_table(rd) -> dict:
    """A daemon's channel table: every field of each channel's record but
    its last outputs and encoder (the queue by its length, a redirect by
    its presence)."""
    skip = ("last_info", "opus_encoder", "agg", "dest_sock")
    return {s: {**{f: getattr(c, f) for f in c.__dataclass_fields__ if f not in skip},
                "agg": len(c.agg), "dest_sock": c.dest_sock is not None}
            for s, c in rd.chans.items()}


def assert_same_mirrors(jr, tr):
    """The groups, their host mirrors (each key a group has) and the
    params trees of the two daemons equal."""
    assert list(jr.engine.groups) == list(tr.engine.groups)
    for name, jg in jr.engine.groups.items():
        tg = tr.engine.groups[name]
        assert dataclasses.asdict(tg.spec) == dataclasses.asdict(jg.spec), name
        assert sorted(tg.host) == sorted(jg.host), name
        for k, v in jg.host.items():
            if isinstance(v, dict):
                for kk, vv in v.items():
                    np.testing.assert_array_equal(tg.host[k][kk], vv, err_msg=f"{name}/{k}/{kk}")
            else:
                np.testing.assert_array_equal(tg.host[k], v, err_msg=f"{name}/{k}")
    assert_same_tree(tree_np(tr.params), jax.device_get(jr.params))


class DaemonPair:
    """The JAX daemon `j` and the port's `t` (device "cpu") on one config.
    dispatch "graph" patches the emulated graph body into the port's daemon
    (monkeypatch: a pytest fixture's). `scene(b, L, rng)` makes block b;
    scene None leaves each daemon its own front end (a file capture both
    read). step() feeds both the same blocks, cmd() the same command packet;
    a background restock lands in both before the next block or state
    comparison; check() steps more blocks and holds the two to each
    other."""

    def __init__(self, conf: str, dispatch: str, monkeypatch, scene, seed: int = 0,
                 fixed_pool: bool = True):
        from ka9q_radio_tpu.config import load_config as jload
        from ka9q_radio_tpu.runtime.radiod import Radiod as JRadiod
        from ka9q_radio_tpu_torch.config import load_config as tload
        from ka9q_radio_tpu_torch.runtime import radiod as tradiod
        from ka9q_radio_tpu_torch.runtime.graphs import GraphStep

        assert dispatch in ("eager", "graph")
        if dispatch == "graph":
            class Emulated(GraphStep):
                def __init__(self, eng, time_shards=0):
                    super().__init__(eng, time_shards, emulate=True)

            monkeypatch.setattr(tradiod, "GraphStep", Emulated)
        self.dispatch = dispatch
        self.j = JRadiod(jload(conf), use_network=False)
        self.t = tradiod.Radiod(tload(conf), use_network=False, device="cpu")
        if fixed_pool:
            # the provisioning rule reads the host's clock: size restocks
            # by dyn-slots alone
            for rd in (self.j, self.t):
                rd._pool_need = lambda gname: 0
        self.scene, self.rng = scene, np.random.default_rng(seed)

    def step(self, n: int = 1):
        """n dispatches of both daemons, each after landing any background
        restock in both (a swap lands at the same block in each)."""
        D = self.t._time_shards
        for _ in range(n):
            self.settle()
            if self.scene is None:
                self.j.step_block()
                self.t.step_block()
                continue
            L, b = self.t.engine.L, self.t.blocks
            x = (np.stack([self.scene(b + d, L, self.rng) for d in range(D)]) if D
                 else self.scene(b, L, self.rng))
            self.j.step_block(block=x)
            self.t.step_block(block=x)

    def send(self, fields: dict):
        """One command packet to both; returns the port's channel."""
        pkt = encode_status(fields, cmd=True)
        self.j.handle_packet(pkt)
        self.t.handle_packet(pkt)
        return self.t.chans.get(fields.get(T.OUTPUT_SSRC))

    def cmd(self, ssrc: int, **kv):
        return self.send({T.OUTPUT_SSRC: ssrc, **{T[k]: v for k, v in kv.items()}})

    def settle(self):
        """Land any background pool restock now (its timing is the host's)."""
        for rd in (self.j, self.t):
            rd._finish_restock(wait=True)

    def assert_same_state(self):
        """Channel tables, free slots, doppler, host mirrors and params."""
        j, t = self.j, self.t
        self.settle()
        tt, tj = chan_table(t), chan_table(j)
        assert tt == tj, {s: (tt.get(s), tj.get(s)) for s in set(tt) | set(tj)
                          if tt.get(s) != tj.get(s)}
        assert {g: sorted(v) for g, v in t.free_slots.items()} == \
            {g: sorted(v) for g, v in j.free_slots.items()}
        assert t.doppler == j.doppler
        assert_same_mirrors(j, t)

    def check(self, steps: int = 1, skip=()):
        """Step `steps` more blocks (a params leaf a writer replaced raises
        at the next graph dispatch), then hold the daemons to each other:
        state, the packets so far (status fields in `skip` left to the
        caller), and in graph dispatch graph_stats() (every dispatch
        emulated, no eager block but the spectrum's counted warm-up
        frames)."""
        self.step(steps)
        self.assert_same_state()
        assert_same_wire(self.j._sent, self.t._sent, self.t.registry, skip)
        st = self.t.graph_stats()
        if self.dispatch == "graph":
            assert st["current"]["dispatch"] == "emulated"
            for part in (st["current"], st["before"]):
                for why in part["eager_blocks"]:
                    assert "spectrum warm-up" in why, st
            assert st["current"]["replays"] + st["before"]["replays"] > 0
        else:
            assert st["current"]["dispatch"] == "eager" and st["current"]["replays"] == 0
