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
