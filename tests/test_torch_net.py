"""The port's copies of the wire protocols against the JAX package's: every
status TLV, RTP header, sample encoding and payload-registry entry gives
byte-identical packets and decodes to the same values."""
import numpy as np
import pytest

from ka9q_radio_tpu.net import rtp as jrtp
from ka9q_radio_tpu.net import status as jst
from ka9q_radio_tpu_torch.net import rtp as trtp
from ka9q_radio_tpu_torch.net import status as tst


def _value(kind_name: str, i: int, rng):
    """A value of each wire kind (numpy seed), exercising signs and sizes."""
    return {
        "int": int(rng.integers(-2**31, 2**31)) if i % 3 else int(rng.integers(0, 2**40)),
        "float": float(np.float32(rng.standard_normal() * 10.0 ** rng.integers(-6, 6))),
        "double": float(rng.standard_normal() * 1e6),
        "string": f"radiod channel {i} µ",
        "socket": (f"239.{i % 256}.{(7 * i) % 256}.1", int(rng.integers(1, 65535))),
        "vector": [float(np.float32(x)) for x in rng.standard_normal(17)],
        "bytes": bytes(rng.integers(0, 256, 33, dtype=np.uint8)),
    }[kind_name]


def test_status_types_and_kinds_equal():
    assert [(t.name, t.value) for t in tst.StatusType] == [(t.name, t.value) for t in jst.StatusType]
    assert {t.name: k.value for t, k in tst.KINDS.items()} == \
        {t.name: k.value for t, k in jst.KINDS.items()}


@pytest.mark.parametrize("cmd", [False, True])
def test_every_tlv_byte_identical(cmd):
    """One packet per StatusType (and one with every type at once): the two
    encoders give the same bytes, and each package decodes the other's
    packet to the same values."""
    rng = np.random.default_rng(5)
    tf, jf = {}, {}
    for i, t in enumerate(tst.StatusType):
        if t == tst.StatusType.EOL:
            continue
        kind = tst.KINDS.get(t, tst.Kind.INT).value
        v = _value(kind, i, rng)
        tf[t], jf[jst.StatusType(t.value)] = v, v
        one_t = tst.encode_status({t: v}, cmd=cmd)
        one_j = jst.encode_status({jst.StatusType(t.value): v}, cmd=cmd)
        assert one_t == one_j, t.name
    pt, pj = tst.encode_status(tf, cmd=cmd), jst.encode_status(jf, cmd=cmd)
    assert pt == pj
    (kt, ft, rt), (kj, fj, rj) = tst.decode_status(pj), jst.decode_status(pt)
    assert kt.value == kj.value == (1 if cmd else 0)
    assert rt == rj
    assert {t.value: v for t, v in ft.items()} == {t.value: v for t, v in fj.items()}


@pytest.mark.parametrize("marker", [False, True])
def test_rtp_header_byte_identical(marker):
    rng = np.random.default_rng(6)
    for _ in range(50):
        kw = dict(type=int(rng.integers(0, 128)), seq=int(rng.integers(0, 65536)),
                  timestamp=int(rng.integers(0, 2**32)), ssrc=int(rng.integers(0, 2**32)),
                  marker=marker)
        b = trtp.RtpHeader(**kw).pack()
        assert b == jrtp.RtpHeader(**kw).pack()
        payload = bytes(rng.integers(0, 256, 40, dtype=np.uint8))
        ht, pt = trtp.RtpHeader.unpack(b + payload)
        hj, pj = jrtp.RtpHeader.unpack(b + payload)
        assert pt == pj == payload
        assert (ht.type, ht.seq, ht.timestamp, ht.ssrc, ht.marker) == \
            (hj.type, hj.seq, hj.timestamp, hj.ssrc, hj.marker)


@pytest.mark.parametrize("enc", [e.name for e in trtp.Encoding
                                 if e.name not in ("NO_ENCODING", "OPUS", "OPUS_VOIP", "AX25")])
def test_sample_encodings_byte_identical(enc):
    """PCM (s16, f32, f16, both orders) and G.711 (mu-law, A-law) over a
    range that clips, from both packages; the decodes agree too."""
    rng = np.random.default_rng(7)
    a = np.concatenate([rng.uniform(-1.2, 1.2, 997), [0.0, 1.0, -1.0, 1e-6, -1e-6]]).astype(np.float32)
    bt = trtp.encode_samples(a, trtp.Encoding[enc])
    assert bt == jrtp.encode_samples(a, jrtp.Encoding[enc])
    np.testing.assert_array_equal(trtp.decode_samples(bt, trtp.Encoding[enc]),
                                  jrtp.decode_samples(bt, jrtp.Encoding[enc]))


def test_payload_registry_equal():
    """The static table, then the dynamic types handed out in order."""
    t, j = trtp.PayloadRegistry(), jrtp.PayloadRegistry()
    assert {k: (r, c, e.value) for k, (r, c, e) in t.table.items()} == \
        {k: (r, c, e.value) for k, (r, c, e) in j.table.items()}
    for rate in (8000, 12_000, 16_000, 24_000, 32_000, 48_000, 96_000, 384_000):
        for ch in (1, 2):
            for e in trtp.Encoding:
                assert t.pt_from_info(rate, ch, e) == j.pt_from_info(rate, ch, jrtp.Encoding(e.value))
    for pt in range(128):
        it, ij = t.info_from_pt(pt), j.info_from_pt(pt)
        assert (it is None) == (ij is None)
        if it is not None:
            assert (it[0], it[1], it[2].value) == (ij[0], ij[1], ij[2].value)


# ------------------------------------------- the receiver's sequence state
def _rtp_sequence(rng, n: int = 400, samples: int = 240):
    """A receiver's view of a stream from a seed: sequence numbers that
    start near the 16-bit wrap and cross it, with gaps (drops), repeats
    (duplicates) and late packets, each with its RTP timestamp."""
    seq, ts, out = 0xFFFF - 60, 1_000_000, []
    for _ in range(n):
        r = rng.random()
        if r < 0.08:
            step = int(rng.integers(2, 5))  # 1-3 packets lost
        elif r < 0.12:
            step = 0  # the last packet again
        elif r < 0.14:
            step = -int(rng.integers(1, 4))  # a late packet
        else:
            step = 1
        seq = (seq + step) & 0xFFFF
        ts = (ts + step * samples) & 0xFFFFFFFF
        out.append((seq, ts))
    return out


def test_rtp_state_matches_jax():
    """tests/test_net.py:103's accounting on a longer stream: the same
    headers through both packages' RtpState give the same return value
    packet by packet and the same counters, across the 16-bit wrap."""
    rng = np.random.default_rng(17)
    js, ts = jrtp.RtpState(), trtp.RtpState()
    seqs = _rtp_sequence(rng)
    assert any(b < a for (a, _), (b, _) in zip(seqs, seqs[1:]))  # crosses the wrap
    for seq, stamp in seqs:
        rj = js.process(jrtp.RtpHeader(type=77, seq=seq, timestamp=stamp, ssrc=9), 240)
        rt = ts.process(trtp.RtpHeader(type=77, seq=seq, timestamp=stamp, ssrc=9), 240)
        assert rt == rj, (seq, stamp)
    assert js.drops > 0 and js.dupes > 0
    assert {k: getattr(ts, k) for k in ts.__dataclass_fields__} == \
        {k: getattr(js, k) for k in js.__dataclass_fields__}
    # and tests/test_net.py:103's own steps on the port
    st = trtp.RtpState()
    assert st.process(trtp.RtpHeader(type=77, seq=100, timestamp=0, ssrc=1), 240) == 0
    assert st.process(trtp.RtpHeader(type=77, seq=101, timestamp=240, ssrc=1), 240) == 0
    assert st.process(trtp.RtpHeader(type=77, seq=104, timestamp=960, ssrc=1), 240) == 480
    assert st.drops == 2
    assert st.process(trtp.RtpHeader(type=77, seq=104, timestamp=960, ssrc=1), 240) < 0
    assert st.dupes == 1


# ----------------------------------------------------- the output sockets
def _sockopts(s) -> tuple:
    import socket

    return (s.getsockopt(socket.IPPROTO_IP, socket.IP_TOS),
            s.getsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_IF, 12),
            s.getsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_TTL),
            s.getsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_LOOP))


@pytest.mark.parametrize("kw", [{}, {"tos": 0x10, "iface": "lo"}, {"tos": 0x48, "iface": "127.0.0.1"},
                                {"iface": "no-such-iface0"}])
@pytest.mark.parametrize("connected", [True, False])
def test_output_socket_options_match_jax(kw, connected):
    """tests/test_net.py:119: `tos =` sets the IP DSCP byte (EF by
    default) and `iface =` the outgoing multicast interface; the port's
    sockets carry the same IP_TOS, IP_MULTICAST_IF, TTL and loop options
    as the JAX package's, for a name, an address and an unknown name."""
    from ka9q_radio_tpu.net import multicast as jmc
    from ka9q_radio_tpu_torch.net import multicast as tmc

    name = "output_socket" if connected else "output_socket_unconnected"
    dest = ("239.1.2.3", 5004)
    sj, st = getattr(jmc, name)(dest, ttl=1, **kw), getattr(tmc, name)(dest, ttl=1, **kw)
    try:
        assert _sockopts(st) == _sockopts(sj)
        assert _sockopts(st)[0] == kw.get("tos", 46 << 2)
    finally:
        sj.close()
        st.close()


# ------------------------------------------------- the decoder on garbage
def _canon(v):
    """A decoded value in a form == can compare (NaN equal to NaN, the
    packages' enums by value)."""
    if isinstance(v, float):
        return ("f", repr(v))
    if isinstance(v, (list, tuple)):
        return tuple(_canon(x) for x in v)
    if hasattr(v, "value") and hasattr(v, "name"):
        return ("enum", v.value)
    return v


def _outcome(decode, pkt: bytes):
    try:
        ptype, fields, unknown = decode(pkt)
    except Exception as e:  # noqa: BLE001 - the exception's type is the outcome
        return ("raise", type(e).__name__)
    return ("ok", ptype.value, {k.value: _canon(v) for k, v in fields.items()},
            {k: bytes(v) for k, v in unknown.items()})


def test_status_decoder_on_garbage_matches_jax():
    """tests/test_net.py:137's hostile datagrams (random bytes, every
    truncation of a real packet, oversized packets, bit flips; a numpy
    seed): the port's
    decode_status raises where the JAX package's does (the same exception
    type) and otherwise returns the same packet type, fields and unknown
    TLVs; the intact packet still decodes."""
    rng = np.random.default_rng(3)
    T = tst.StatusType
    good = tst.encode_status({T.OUTPUT_SSRC: 50, T.RADIO_FREQUENCY: 1e6, T.DESCRIPTION: "x" * 200,
                              T.BIN_DATA: [1.0] * 64}, cmd=True)
    pkts = [bytes(rng.integers(0, 256, rng.integers(0, 120), dtype=np.uint8)) for _ in range(500)]
    pkts += [good[:n] for n in range(len(good))]
    # oversized: the good packet with trailing garbage, and long random ones
    pkts += [good + bytes(rng.integers(0, 256, rng.integers(1, 600), dtype=np.uint8))
             for _ in range(100)]
    pkts += [bytes(rng.integers(0, 256, rng.integers(1000, 9000), dtype=np.uint8))
             for _ in range(20)]
    for _ in range(300):
        b = bytearray(good)
        b[int(rng.integers(0, len(b)))] ^= int(rng.integers(1, 256))
        pkts.append(bytes(b))
    kinds = set()
    for i, pkt in enumerate(pkts):
        want, got = _outcome(jst.decode_status, pkt), _outcome(tst.decode_status, pkt)
        assert got == want, (i, pkt.hex())
        kinds.add(want[0])
    assert kinds == {"raise", "ok"}  # both outcomes occur
    _, f, _ = tst.decode_status(good)
    assert f[T.OUTPUT_SSRC] == 50
