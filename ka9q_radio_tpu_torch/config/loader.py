"""radiod.conf-compatible INI loader -> Engine specification.

Parses the reference's config dialect (radio.c loadconfig + modes.c
loadpreset): a [global] section, one hardware section named by
`hardware =` (only the sig_gen device is meaningful on TPU — real SDR
front ends stream over the network into the host edge), and one channel
section per receiver group. Each channel section resolves its settings by
layered precedence *compiled defaults < [global] < preset < section*
(radio.c:713-727) and expands `freq`/`freq0..9` and `raster`/`raster0..9
= start stop step` lists (radio.c:795-919, frequencies parsed with the
k/m/g heuristic). SSRC defaults to the kHz of the frequency (radio.c:936).

Each channel section becomes one GroupSpec (a batched rate class); the
whole file becomes a RadiodConfig the runtime daemon turns into an Engine.
"""
from __future__ import annotations

import dataclasses
import io
import re
from typing import Any

from ..runtime.engine import ChannelSpec, GroupSpec
from ..runtime.source import SigGenConfig
from ..utils.parse import parse_frequency
from .presets import preset_table

__all__ = ["RadiodConfig", "load_config", "parse_bool", "parse_ini"]

_TRUE = {"y", "yes", "true", "on", "1"}
_FALSE = {"n", "no", "false", "off", "0"}


def parse_bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    s = str(v).strip().lower()
    if s in _TRUE:
        return True
    if s in _FALSE:
        return False
    raise ValueError(f"not a boolean: {v!r}")


def parse_ini(text: str) -> dict[str, dict[str, str]]:
    """Tiny iniparser-alike: case-insensitive keys, '#'/';' comments,
    quoted values, duplicate keys last-wins, sections ordered."""
    sections: dict[str, dict[str, str]] = {}
    cur: dict[str, str] | None = None
    pending = ""
    for raw in io.StringIO(text):
        line = pending + raw.rstrip("\n")
        pending = ""
        if line.endswith("\\"):
            pending = line[:-1]
            continue
        # strip comments (respect quotes)
        out, q = [], None
        for ch in line:
            if q:
                if ch == q:
                    q = None
                out.append(ch)
            elif ch in "\"'":
                q = ch
                out.append(ch)
            elif ch in "#;":
                break
            else:
                out.append(ch)
        line = "".join(out).strip()
        if not line:
            continue
        m = re.match(r"^\[(.+?)\]$", line)
        if m:
            cur = sections.setdefault(m.group(1).strip().lower(), {})
            continue
        if cur is None or "=" not in line:
            continue
        k, _, v = line.partition("=")
        v = v.strip()
        if len(v) >= 2 and v[0] == v[-1] and v[0] in "\"'":
            v = v[1:-1]
        cur[k.strip().lower()] = v
    return sections


@dataclasses.dataclass
class RadiodConfig:
    blocktime: float
    overlap: int
    # SigGenConfig (synthetic), a descriptor dict for file/rtp front ends,
    # or None (an external feeder passes blocks to step_block directly)
    source: "SigGenConfig | dict | None"
    groups: list[GroupSpec]
    samprate: float
    real: bool
    options: dict[str, str]  # remaining [global] keys (status/data names, ttl...)
    warnings: list = dataclasses.field(default_factory=list)  # unknown keys etc.
    source_path: "str | None" = None  # file the config came from (fft.log)
    # front-end center frequency (the reference's Frontend.frequency,
    # `frequency =` in the hardware section): dial RF maps to IF =
    # freq - center. 0 (default) = direct/baseband addressing.
    center: float = 0.0
    # multi-front-end extension: `[global] hardware = fe0 fe1 ...` lists
    # several same-geometry hardware sections; ONE daemon/engine serves
    # them all (batched master). `source`/`center` stay the first entry.
    sources: list = dataclasses.field(default_factory=list)
    centers: list = dataclasses.field(default_factory=list)
    hw_names: list = dataclasses.field(default_factory=list)

    @property
    def n_inputs(self) -> int:
        return max(1, len(self.hw_names))


def _expand_freqs(sec: dict[str, str]) -> list[tuple]:
    """freq/raster lists -> [(freq_hz, tone_hz, hw_name|None)]
    (radio.c:795-930). Numbered sub-lists may carry their own tone AND —
    our multi-front-end extension — their own `hardware<i> =` binding, so
    one rate-class section can stripe channels across streams."""
    out: list[tuple] = []
    for i in [""] + [str(d) for d in range(10)]:
        tone = float(sec.get(f"tone{i}", sec.get(f"pl{i}", sec.get(f"ctcss{i}", 0.0)) or 0.0) or 0.0)
        hw = sec.get(f"hardware{i}") if i else None  # bare `hardware` = group key
        hw = hw.strip().lower() if hw else None
        r = sec.get(f"raster{i}")
        if r:
            toks = r.split()
            if len(toks) != 3:
                raise ValueError(f"bad raster: {r!r}")
            start, stop, step = (parse_frequency(t, True) for t in toks)
            if start > stop:
                start, stop = stop, start
            if step <= 0:
                # a zero/negative step would append channels until OOM
                raise ValueError(f"bad raster step: {r!r}")
            f = start
            while f < stop:
                out.append((f, tone, hw))
                f += step
        fl = sec.get(f"freq{i}")
        if fl:
            for tok in fl.split():
                out.append((parse_frequency(tok, True), tone, hw))
    # except list removes matching frequencies
    exc = set()
    for i in [""] + [str(d) for d in range(10)]:
        el = sec.get(f"except{i}")
        if el:
            exc.update(parse_frequency(t, True) for t in el.split())
    return [e for e in out if e[0] not in exc]


_CHANNEL_ONLY_KEYS = {
    "mode", "preset", "ssrc", "freq", "raster", "except", "tone", "pl",
    "ctcss", "filter2", "encoding", "block", "update", "ttl", "data",
    "lifetime", "prio", "disable", "hardware",
}
_GLOBAL_KEYS = {
    "hardware", "status", "data", "mode", "preset", "ttl", "blocktime",
    "overlap", "update", "encoding", "block", "lifetime", "wisdom",
    "advertise", "rds", "native-edge", "description", "rtcp-interval",
    "spectrum-format", "spectrum-base", "spectrum-step", "iface", "matmul", "sap",
    "fft-threads", "fft-plan-level", "fft", "fft-precision", "dns", "tos", "spurs",
    "mesh", "fail-deadline", "dyn-slots", "prealloc", "restart", "noise-every",
    "time-shards",
}

_GROUP_KEYS = {
    "demod", "samprate", "low", "high", "kaiser-beta",
    "squelch-open", "squelch-close", "squelch-tail", "squelchtail",
    "headroom", "hang-time", "recovery-rate", "threshold", "gain", "pll-bw",
    "pll", "square", "envelope", "agc", "snr-squelch", "mono", "stereo",
    "channels", "conj", "threshold-extend", "extend", "deemph-tc",
    "deemph-gain", "dc-cut", "shift", "beam", "a-amp", "a-phase", "b-amp", "b-phase",
    # spectrum
    "resolution-bw", "bin-count", "window-type", "spectrum-shape",
    "fft-avg", "spectrum-overlap", "lazy", "idle-timeout",
    # squelch-gated egress compaction (audio.c:42-110 analog)
    "egress-slots",
}


def _build_group(name: str, settings: dict[str, Any], freqs: list[tuple],
                 hw_index: "dict[str, int] | None" = None) -> GroupSpec:
    # freqs entries: (freq, tone) or (freq, tone, hw_name); hw_index maps
    # per-sub-list hardware names to engine input indices
    norm = []
    for e in freqs:
        f, tone = e[0], e[1]
        hw = e[2] if len(e) > 2 else None
        inp = None
        if hw:
            if not hw_index or hw not in hw_index:
                raise ValueError(f"[{name}]: unknown hardware {hw!r}")
            inp = hw_index[hw]
        norm.append((f, tone, inp))
    freqs = [(f, t) for f, t, _ in norm]
    s = settings
    demod = str(s.get("demod", "linear")).lower()
    envelope = parse_bool(s.get("envelope", False))
    pll = parse_bool(s.get("pll", False))
    square = parse_bool(s.get("square", False))
    stereo = parse_bool(s.get("stereo", False)) or not parse_bool(s.get("mono", True))
    if str(s.get("channels", "")).strip() == "2":
        stereo = True
    if demod == "linear":
        if envelope and pll:
            demod = "sam"
        elif envelope:
            demod = "am"
        elif stereo and not parse_bool(s.get("conj", False)):
            demod = "iq"

    def fnum(key, default=None):
        v = s.get(key, default)
        return None if v is None else float(parse_frequency(v)) if isinstance(v, str) else float(v)

    shift = fnum("shift", 0.0) or 0.0
    chans = tuple(
        ChannelSpec(
            freq=f,
            low=fnum("low", -5000.0),
            high=fnum("high", 5000.0),
            shift_hz=shift,
            tone_freq=tone,
            ssrc=int(s["ssrc"]) if "ssrc" in s and len(freqs) == 1 else None,
            input=inp,
        )
        for (f, tone), (_, _, inp) in zip(freqs, norm)
    )
    tail = s.get("squelch-tail", s.get("squelchtail"))
    kw: dict[str, Any] = dict(
        name=name,
        demod=demod if demod in ("fm", "wfm", "spectrum", "am", "sam", "iq") else "linear",
        samprate=int(round(parse_frequency(s.get("samprate", 12_000)))),
        channels=chans,
        enable_pll=pll or square,
        pll_square=square,
        envelope=envelope,
        stereo=stereo,
        agc=parse_bool(s.get("agc", True)),
        snr_squelch=parse_bool(s.get("snr-squelch", False)),
        threshold_extend=parse_bool(s.get("threshold-extend", s.get("extend", False))),
        ctcss=any(t != 0.0 for _, t in freqs),
        squelch_tail=int(tail) if tail is not None else None,
        kaiser_beta=float(s.get("kaiser-beta", 11.0)),
        encoding=str(s["encoding"]).lower() if "encoding" in s else None,
        data=str(s["data"]).strip() if s.get("data") else None,
        update=abs(int(s["update"])) if "update" in s else None,
        ttl=int(s["ttl"]) if "ttl" in s else None,
        filter2=int(s.get("filter2", 0) or 0),
        isb=parse_bool(s.get("conj", False)),
        egress_slots=int(s.get("egress-slots", 0) or 0),
    )
    if parse_bool(s.get("beam", False)):
        import cmath
        a = float(s.get("a-amp", 1.0)) * cmath.exp(1j * cmath.pi * float(s.get("a-phase", 0.0)) / 180.0)
        b = float(s.get("b-amp", 0.0)) * cmath.exp(1j * cmath.pi * float(s.get("b-phase", 0.0)) / 180.0)
        kw.update(beam=True, a_weight=a, b_weight=b)
    for ini_key, field in [
        ("squelch-open", "squelch_open_db"), ("squelch-close", "squelch_close_db"),
        ("headroom", "headroom_db"), ("hang-time", "hangtime_s"),
        ("recovery-rate", "recovery_rate_db"), ("threshold", "threshold_db"),
        ("gain", "gain_db"), ("pll-bw", "pll_bw_hz"),
        ("deemph-tc", "deemph_tc_us"), ("deemph-gain", "deemph_gain_db"),
        ("dc-cut", "dc_cut_hz"),
    ]:
        if ini_key in s and s[ini_key] is not None and str(s[ini_key]) != "":
            kw[field] = float(parse_frequency(s[ini_key])) if isinstance(s[ini_key], str) else float(s[ini_key])
    if demod == "spectrum":
        if "resolution-bw" in s:
            kw["bin_bw"] = float(parse_frequency(s["resolution-bw"]))
        if "bin-count" in s:
            kw["bin_count"] = int(s["bin-count"])
        if "fft-avg" in s:
            kw["fft_avg"] = int(s["fft-avg"])
        if "spectrum-overlap" in s:
            kw["spectrum_overlap"] = float(s["spectrum-overlap"])
        if "lazy" in s:
            kw["spectrum_lazy"] = parse_bool(s["lazy"])
        if "idle-timeout" in s:
            kw["spectrum_idle_s"] = float(s["idle-timeout"])
    return GroupSpec(**kw)


def _build_source(sec: dict[str, str], center: float = 0.0) -> SigGenConfig:
    from ..utils.units import dB_to_power

    real = parse_bool(sec.get("real", "y")) and not parse_bool(sec.get("complex", "n"))
    amp_db = float(sec.get("amplitude", -20.0))
    fs = parse_frequency(sec.get("samprate", "30m0"))
    # noise keys, reference-exact (sig_gen.c:149-156):
    #   "noise" = per-sample Gaussian amplitude in dBFS (each of I/Q unit
    #   variance scaled by it) -> true density N0 = 2*sigma^2/fs for both
    #   real and complex streams;
    #   "n0"    = noise density in dBFS/Hz directly (true density; the
    #   reference's 0.5*sqrt(fs) scaling lands its actual density 3 dB
    #   below the config value — we generate the stated density).
    noise_db, n0_db = sec.get("noise"), sec.get("n0")
    if noise_db is not None:
        sigma = 10.0 ** (float(noise_db) / 20.0)
        n0 = 2.0 * sigma * sigma / fs
    elif n0_db is not None:
        n0 = float(dB_to_power(float(n0_db)))
    else:
        n0 = 0.0
    return SigGenConfig(
        samprate=fs,
        real=real,
        # the generator works in IF: a carrier dialed at RF c lands at
        # c - center (sig_gen.c:224 offsets by frontend->frequency)
        carrier_hz=parse_frequency(sec.get("carrier", "10m0")) - center,
        amplitude=float(10.0 ** (amp_db / 20.0)),
        noise_n0=n0,
        am_depth=0.3 if str(sec.get("modulation", "")).lower() == "am" else 0.0,
        fm_deviation_hz=3000.0 if str(sec.get("modulation", "")).lower() == "fm" else 0.0,
    )


def load_config(text_or_path: str, presets: dict[str, dict] | None = None) -> RadiodConfig:
    """Load a radiod .conf (path or literal text).

    Like the reference (radio.c:181-278), a `<path>.d/` directory (or the
    path itself being a directory) is concatenated in sorted order after
    the base file.
    """
    import os

    source_path = None
    if "\n" not in text_or_path and not text_or_path.lstrip().startswith("["):
        source_path = os.path.abspath(text_or_path)
        parts = []
        if os.path.isdir(text_or_path):
            d = text_or_path
        else:
            with open(text_or_path) as fh:
                parts.append(fh.read())
            d = text_or_path + ".d"
        if os.path.isdir(d):
            for name in sorted(os.listdir(d)):
                if name.endswith(".conf"):
                    with open(os.path.join(d, name)) as fh:
                        parts.append(fh.read())
        text = "\n".join(parts)
    else:
        text = text_or_path
    ini = parse_ini(text)
    if "global" not in ini:
        raise ValueError("no [global] section")
    g = dict(ini["global"])
    presets = presets or preset_table()

    blocktime = float(g.get("blocktime", 20.0)) * 1e-3
    overlap = int(g.get("overlap", 5))
    # multiple same-geometry front ends: `hardware = fe0 fe1 ...` — ONE
    # engine serves them all (the reference needs a radiod per SDR)
    hw_names = [t.strip().lower() for t in g.get("hardware", "").split()]

    def _load_hw(hw_name: str):
        if hw_name not in ini:
            raise ValueError(f"hardware section [{hw_name}] missing")
        hw = ini[hw_name]
        device = hw.get("device", hw_name).strip().strip('"').lower()
        # `frequency =` is the front-end center (Frontend.frequency): dial
        # RF maps to IF = freq - center (for network/file ingest, the
        # center the STREAM was captured at)
        center = float(parse_frequency(hw.get("frequency", 0.0))) if "frequency" in hw else 0.0
        if device == "sig_gen":
            source = _build_source(hw, center)
            samprate, real = source.samprate, source.real
        elif device == "file":
            samprate = parse_frequency(hw.get("samprate", "0"))
            fmt = hw.get("format", "cf32le")
            real = not fmt.startswith("c")
            source = {
                "kind": "file", "path": hw["path"], "samprate": samprate,
                "format": fmt, "loop": parse_bool(hw.get("loop", "n")),
            }
        elif device == "rtp":
            samprate = parse_frequency(hw.get("samprate", "0"))
            real = parse_bool(hw.get("real", "n"))
            source = {
                "kind": "rtp", "stream": hw.get("stream", hw.get("data", "")),
                "samprate": samprate, "real": real,
                "encoding": hw.get("encoding", "s16be"),
                "ssrc": int(hw["ssrc"]) if "ssrc" in hw else None,
                # native = n forces the Python reassembly fallback
                "native": parse_bool(hw.get("native", "y")),
            }
        else:
            # unknown hardware: record geometry; feeder must supply blocks
            samprate = parse_frequency(hw.get("samprate", "0"))
            real = parse_bool(hw.get("real", "y")) and not parse_bool(hw.get("complex", "n"))
            source = None
        return source, samprate, real, center

    source = None
    sources: list = []
    centers: list = []
    samprate = 0.0
    real = True
    center = 0.0
    for i, hw_name in enumerate(hw_names):
        src_i, fs_i, real_i, ctr_i = _load_hw(hw_name)
        if i == 0:
            source, samprate, real, center = src_i, fs_i, real_i, ctr_i
        elif fs_i != samprate or real_i != real:
            raise ValueError(
                f"hardware [{hw_name}]: rate/type {fs_i}/{real_i} differs "
                f"from [{hw_names[0]}] {samprate}/{real} — all front ends "
                "of one engine must share the master geometry")
        sources.append(src_i)
        centers.append(ctr_i)

    default_mode = g.get("mode", g.get("preset", "")).strip().lower()
    groups: list[GroupSpec] = []
    warnings: list[str] = []
    for k in g:
        if k not in _GLOBAL_KEYS and k not in _GROUP_KEYS:
            warnings.append(f"[global]: unknown key {k!r}")
    for name, sec in ini.items():
        if name == "global" or name in hw_names:
            continue
        if "device" in sec:
            continue  # another hardware section
        if parse_bool(str(sec.get("disable", "no"))):
            continue  # disable = yes keeps the section on file (radio.c:541)
        freqs = _expand_freqs(sec)
        if not freqs:
            continue  # pure template/disabled section
        mode = str(sec.get("mode", sec.get("preset", default_mode))).strip().lower()
        for k in sec:
            base = k.rstrip("0123456789")
            if k not in _GROUP_KEYS and base not in _CHANNEL_ONLY_KEYS:
                warnings.append(f"[{name}]: unknown key {k!r}")
        settings: dict[str, Any] = {}
        # layered precedence: defaults ◁ [global] ◁ preset ◁ section
        for k in _GROUP_KEYS & set(g):
            settings[k] = g[k]
        if mode:
            if mode not in presets:
                raise ValueError(f"[{name}]: unknown preset {mode!r}")
            settings.update(presets[mode])
        for k in _GROUP_KEYS & set(sec):
            settings[k] = sec[k]
        # channel-only keys that ride the GroupSpec as host-edge hints
        for k in ("ssrc", "encoding", "data", "update", "ttl"):
            if k in sec:
                settings[k] = sec[k]
        hw_index = {n: i for i, n in enumerate(hw_names)}
        grp = _build_group(name, settings, freqs, hw_index=hw_index)
        # per-section front-end binding (multi-hardware configs):
        # `hardware = fe1` selects which stream feeds this group
        # (numbered freq sub-lists may override per channel, hardware0..9)
        if "hardware" in sec:
            want = sec["hardware"].strip().lower()
            if want not in hw_index:
                raise ValueError(f"[{name}]: unknown hardware {want!r}")
            grp = dataclasses.replace(grp, input=hw_index[want])
        groups.append(grp)

    return RadiodConfig(
        blocktime=blocktime,
        overlap=overlap,
        source=source,
        groups=groups,
        samprate=samprate,
        real=real,
        options={k: v for k, v in g.items() if k not in ("blocktime", "overlap", "hardware")},
        warnings=warnings,
        source_path=source_path,
        center=center,
        sources=sources,
        centers=centers,
        hw_names=hw_names,
    )
