"""radiod — the daemon: config -> Engine -> RTP data + TLV status over UDP.

The port's counterpart of the reference's main.c/radio_status.c/audio.c
host side: one process owns the engine on the card; per 20 ms block it

  1. drains control packets from the status socket (poll -> full status
     response; settable keys -> params rows written in place, nothing
     rebuilt, mirroring decode_radio_commands radio_status.c:133-702),
  2. pulls one input block from the front end (sig_gen on the card, a file
     or RTP reader, or an external feeder; one [B, L] block from the B
     front ends of several `[hardware]` sections) and copies it to the card,
  3. runs the engine step (D steps with `time-shards = D`), then copies the
     audio and the per-block control leaves back to pinned host memory with
     one synchronisation,
  4. packetizes each unmuted channel's audio as RTP (PCM s16be/f32/
     mu-law/... via net.rtp) and multicasts it,
  5. emits per-channel TLV status beacons every `update` blocks and
     answers polls immediately (response(), radio.c:1563-1593).

Where the reference binds its realtime loop to wall clock (the A/D paces
it), this loop is paced by whoever calls run()/step_block — the benchmark
runs it flat out, a live deployment paces on the source.

A device error is never turned into a dropped block: any exception from the
engine step, the device->host copy or a table rebuild propagates. Block
drops count front-end read gaps only. Every demodulator of the JAX package
runs, beamforming groups and several `[hardware]` inputs included. `mesh =
yes` runs the sharded engine over every local CUDA device (or over a mesh
the caller passes, such as four shards of one card): the distributed master
FFT and each group split into C/D channel rows, or with `time-shards` D
consecutive blocks a dispatch, one a device (Engine.step_time).
"""
from __future__ import annotations

import dataclasses
import os
import select
import sys
import tempfile
import time
from typing import Any, Callable

import numpy as np
import torch

from ..config.loader import RadiodConfig
from ..net.status import StatusType as T, PacketType, encode_status, decode_status
from ..net.rtp import RtpHeader, Encoding, PayloadRegistry, encode_samples
from ..net.multicast import (resolve_dest, output_socket, output_socket_unconnected,
                             listen_socket, DEFAULT_RTP_PORT, DEFAULT_STAT_PORT)
from ..utils.units import power_to_dB, dB_to_power, dB_to_voltage, voltage_to_dB
from ..utils.device import resolve_device
from .engine import Engine, migrate_state
from .source import siggen_init, siggen_block

__all__ = ["Radiod", "DEMOD_TYPE_CODES"]

# where the cold-start log, fft.log, goes when the config names no `wisdom`
DEFAULT_WISDOM = os.path.join(tempfile.gettempdir(), "ka9q_radio_tpu_torch_wisdom")

DEMOD_TYPE_CODES = {"linear": 0, "fm": 1, "wfm": 2, "spectrum": 3}
# sample rates the Opus codec accepts (radio.h legal_opus_samprate)
_OPUS_RATES = (8000, 12_000, 16_000, 24_000, 48_000)

GPS_UTC_OFFSET = 18  # leap seconds (misc.h GPS epoch helpers)
_GPS_EPOCH = 315964800  # 1980-01-06 UTC in unix time


def _gps_time_ns() -> int:
    return int((time.time() - _GPS_EPOCH + GPS_UTC_OFFSET) * 1e9)


def _yes(v) -> bool:
    return str(v).lower() in ("y", "yes", "true", "1", "on")


def _out_format(spec) -> tuple[int, int]:
    """(sample rate, channels) of a group's audio on the wire: WFM sends
    48 kHz stereo (its mono fallback is switched per block), I/Q stereo
    linear two channels, the rest mono at the group's rate."""
    if spec.demod == "wfm":
        return 48_000, 2
    return spec.samprate, 2 if spec.stereo else 1


def _stack_tree(trees: list):
    """[tree, ...] of tensors -> one tree of tensors stacked on a new axis 0."""
    if isinstance(trees[0], dict):
        return {k: _stack_tree([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _host_copy(tree, device: torch.device):
    """Device->host copy of a tree of tensors as numpy arrays: every leaf
    into pinned memory with non_blocking=True, then ONE synchronisation on
    an event (a .cpu() per leaf would synchronise once per leaf)."""
    if device.type != "cuda":
        return _map_tree(tree, lambda t: t.numpy())
    bufs = _map_tree(tree, lambda t: torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     .copy_(t, non_blocking=True))
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    ev.synchronize()
    return _map_tree(bufs, lambda t: t.numpy())


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    return fn(tree)


@dataclasses.dataclass
class _Chan:
    """Host-side bookkeeping for one channel (shadow of struct channel)."""

    group: str
    idx: int
    ssrc: int
    freq: float
    low: float
    high: float
    samprate: int
    channels: int  # audio channels in RTP output
    encoding: Encoding
    pt: int
    rtp_seq: int = 0
    rtp_timestamp: int = 0
    sending: bool = False  # squelch state last block (for the RTP marker bit)
    data_packets: int = 0
    metadata_packets: int = 0
    commands: int = 0
    last_info: dict[str, Any] = dataclasses.field(default_factory=dict)
    opus_encoder: Any = None  # lazily created for Encoding.OPUS channels
    agg: list = dataclasses.field(default_factory=list)  # aggregation queue
    dynamic: bool = False
    lifetime: int = 0  # idle countdown in blocks (0 = immortal)
    lifetime_init: int = 0  # value a poll/command refreshes the countdown to
    options: int = 0  # SETOPTS/CLEAROPTS bitmask (radio.h:338; experimental)
    preset: str = ""  # last applied preset name (radio_status.c:167-209)
    kaiser_beta: float | None = None  # per-channel override (KAISER_BETA cmd)
    filter2_beta: float | None = None  # FILTER2_KAISER_BETA cmd
    update_every: int | None = None  # STATUS_INTERVAL override, blocks (0=off)
    maxdelay: int | None = None  # MAXDELAY: per-channel output aggregation
    spectrum_base: float | None = None  # SPECTRUM_BASE/STEP byte-format scale
    spectrum_step: float | None = None
    dest_sock: Any = None  # OUTPUT_DATA_DEST_SOCKET per-channel redirect
    parked: bool = False  # tuned outside front-end coverage (radio.c:1472)
    opus_bitrate: int = 0  # OPUS_BIT_RATE (0 = auto)
    opus_dtx: bool = False
    opus_app: int | None = None  # OPUS_APPLICATION
    rds: bool = False  # emits the WFM channel's RDS baseband instead of audio


class _LazyGroupInfo:
    """Per-dispatch lazily-fetched group info for BIG channel groups:
    only the leaves the host actually reads (beacon/poll fields) cross
    the d2h boundary, once per dispatch, instead of every [C]-sized
    leaf every block. Leaf access returns the same full [C(, ...)]
    numpy arrays the eager dict would hold; time-sharded dispatches
    share one cache across their D per-block views. It holds the
    dispatch's own output tensors, which no later step writes in place."""

    __slots__ = ("_dev", "_cache", "_d")

    def __init__(self, dev: dict, cache: "dict | None" = None, d=None):
        self._dev = dev
        self._cache = {} if cache is None else cache
        self._d = d

    def view(self, d: int) -> "_LazyGroupInfo":
        return _LazyGroupInfo(self._dev, self._cache, d)

    def __contains__(self, k) -> bool:
        return k in self._dev

    def __bool__(self) -> bool:
        return bool(self._dev)

    def keys(self):
        return self._dev.keys()

    def get(self, k, default=None):
        return self[k] if k in self._dev else default

    def __getitem__(self, k):
        v = self._cache.get(k)
        if v is None:
            v = self._dev[k].cpu().numpy()
            self._cache[k] = v
        return v if self._d is None else v[self._d]



def beacon_plan(classes: list, budget: int) -> list:
    """Fixed beacon slices for a big group's interval classes.

    `classes` is [(u, channels)] with interval u > 0 blocks. Returns
    [(channels, per, period, stride, phase)]: on blocks b with
    b % stride == phase, the class sends the slice k = (b // stride) %
    period of `per` channels, so each of its channels beacons every
    stride * period blocks. Unpressed, a class of C_u channels sends
    ceil(C_u / u) a block and every channel beacons every u blocks. When
    those add up to more than `budget`, each class keeps one encode a block
    and the rest of the budget goes in proportion to the remainder of each
    class's want (largest remainder), so the shares are fixed and sum to
    the budget; the intervals stretch to ceil(C_u / share). With more
    classes than the budget, the classes take turns: `budget` of them a
    block, each with one encode, over stride = ceil(K / budget) blocks."""
    budget = max(1, budget)
    want = [-(-len(chans) // u) for u, chans in classes]
    k = len(classes)
    if sum(want) <= budget:
        shares, stride = want, 1
    elif k <= budget:
        rest, spare = [w - 1 for w in want], budget - k
        quota = [r * spare / sum(rest) for r in rest]
        extra = [int(q) for q in quota]
        for i in sorted(range(k), key=lambda i: extra[i] - quota[i])[: spare - sum(extra)]:
            extra[i] += 1
        shares, stride = [1 + e for e in extra], 1
    else:
        shares, stride = [1] * k, -(-k // budget)
    plan = []
    for i, ((u, chans), per) in enumerate(zip(classes, shares)):
        period = max(-(-u // stride), -(-len(chans) // per))
        plan.append((chans, per, period, stride, i // budget if stride > 1 else 0))
    return plan

class Radiod:
    """The daemon on one device, over one or several front ends. device None
    means CUDA (and raises where there is none); the tests pass
    device="cpu". mesh: a parallel.Mesh to run the sharded engine on (the
    config's `mesh = yes` builds make_mesh(), every local CUDA device)."""

    def __init__(
        self,
        cfg: RadiodConfig,
        use_network: bool = True,
        data_port: int = DEFAULT_RTP_PORT,
        status_port: int = DEFAULT_STAT_PORT,
        device=None,
        mesh=None,
    ):
        self._t_start = time.monotonic()  # the cold start runs to the first block
        self.cfg = cfg
        # [global] mesh = yes: the sharded engine over every local CUDA
        # device (one card: a mesh of one); a caller's mesh takes its place
        if mesh is None and str(cfg.options.get("mesh", "n")).lower() in (
                "y", "yes", "true", "1", "on", "auto"):
            from ..parallel import make_mesh

            mesh = make_mesh()
        self._mesh = mesh
        if mesh is not None:
            if mesh.multiproc:
                raise ValueError("the daemon runs on a mesh of one process (its own devices); "
                                 f"{mesh} spans {mesh.nproc}")
            if device is not None and torch.device(device).type != mesh.home.type:
                raise ValueError(f"device={device} with a mesh of {mesh.home.type} devices")
            device = mesh.home
        self.device = resolve_device(device)
        self._group_dests: dict[str, tuple] = {}  # per-section `data =` cache
        self._use_dns = _yes(cfg.options.get("dns", "n"))
        # `wisdom` names the directory of the cold-start log, fft.log (the
        # reference's missing-wisdom log): `no`/`off` turns it off
        from ..utils.parse import parse_frequency
        spurs = [parse_frequency(t, True) for t in str(cfg.options.get("spurs", "")).split()] or None
        self._spurs = spurs
        self._n_inputs = int(getattr(cfg, "n_inputs", 1))
        self._noise_every = int(cfg.options.get("noise-every", 4))
        # [global] time-shards = D: D consecutive blocks per dispatch, with
        # ONE device->host copy for all D (the same outputs as D single
        # steps); `yes` = 8. With a mesh, D = the mesh size and the blocks
        # run one a device (Engine.step_time)
        self._time_shards = 0
        ts_opt = str(cfg.options.get("time-shards", "n")).lower()
        if ts_opt not in ("n", "no", "false", "0", "off", ""):
            if mesh is not None:
                self._time_shards = mesh.size
            else:
                self._time_shards = int(ts_opt) if ts_opt.isdigit() else 8
        if self.device.type == "cuda":
            # the kernels build here, at startup, never inside the loop
            from ..ops.cuda_channelize import build
            build()
        self.engine = Engine(groups=cfg.groups, **self._engine_kwargs())
        self.state = self.engine.init_state()
        self.step = self._mk_step(self.engine)
        self.params = self.engine.init_params()
        self.source_state = None
        self.frontend = None
        self.frontends = None  # several inputs: one host feeder a stream
        if self._n_inputs > 1:
            self._init_multi_sources(cfg)
        elif isinstance(cfg.source, dict):
            self.frontend = self._feeder(cfg.source)
        elif cfg.source is not None:
            src = cfg.source
            self.source_state = siggen_init(src, device=self.device)
            self._init_siggen(lambda st: siggen_block(src, st, self.engine.L))
        self.registry = PayloadRegistry()
        self.update_every = int(cfg.options.get("update", 25))  # blocks (modes.c:56)
        self.blocks = 0
        # blocks the front end could not fill (read gaps, the analog of the
        # reference's USB transfer-loss accounting, rx888.c:675-688)
        self.block_drops = 0
        _sf = str(cfg.options.get("spectrum-format", "")).lower()
        self.spectrum_byte = _sf == "byte"
        # `rice`: Rice-coded quantized levels (net/rice.py) — our working
        # form of the reference's dead #if RICE experiment
        self.spectrum_rice = _sf == "rice"
        self.spectrum_base = float(cfg.options.get("spectrum-base", -120.0))
        self.spectrum_step = float(cfg.options.get("spectrum-step", 0.5))
        self.default_mode = str(cfg.options.get("mode", cfg.options.get("preset", "usb"))).lower()
        # [global] lifetime (seconds; 0 = infinite, radio.c:71,294)
        self.lifetime_blocks = int(float(cfg.options.get("lifetime", 0.0)) / cfg.blocktime)
        # lazy spectrum gating (spectrum.c:161-186): {group: (armed_at,
        # armed_until) block numbers}; absent = disarmed
        self._spectrum_armed: dict[str, tuple[int, int]] = {}
        # spectrum polls answered after their first armed block (ssrc, tag)
        self._deferred_status: list[tuple[int, int]] = []
        self._sync_spectrum_lazy()
        self.free_slots: dict[str, list[int]] = {}
        self._restock: "dict[str, Any] | None" = None  # in-flight background grow
        self._engine_epoch = 0  # bumped by foreground rebuilds (voids restocks)
        # spare-slot policy for dynamic channels: each table rebuild adds
        # `dyn-slots` extra tombstoned slots so the next creates/moves are
        # pure params surgery (ms) instead of a table rebuild
        self.dyn_spare = max(0, int(cfg.options.get("dyn-slots", 4)))
        self._data_port = data_port
        self.rtcp_sock = None
        self.rtcp_every = int(cfg.options.get("rtcp-interval", 250))  # blocks (~5 s)
        self.description = str(cfg.options.get("description", "ka9q-radio-tpu"))
        # DOPPLER_FREQUENCY/RATE steering (radio_status.c): ssrc -> [offset Hz, Hz/s]
        self.doppler: dict[int, list[float]] = {}
        # runtime params saved when a channel parks (restored on unpark)
        self._park_saves: dict[tuple[str, int], dict] = {}
        self.if_power = 0.0  # smoothed front-end input power (first/only input)
        self.if_power_in = np.zeros(self._n_inputs)  # per-input smoothing
        # per-block wall-time stats (the reference's FFT timing EMA,
        # filter.c:479-530 / main.c:151-188 verbose loop)
        self.t_avg = 0.0
        self.t_min = float("inf")
        self.t_max = 0.0
        # per-block wall-time samples for latency percentiles (the
        # realtime evidence the reference's 10 s self-checks give,
        # main.c:151-188): a bounded ring, ~7 min at 20 ms blocks
        self._t_ring = np.zeros(20_000, np.float32)
        self._t_n = 0
        # the front-end host path's cumulative time (frontend_split)
        self.frontend_host = dict.fromkeys(("reads", "ring_read_s", "stack_s", "copies",
                                            "pin_s", "copy_s", "h2d_bytes"), 0)
        # output aggregation: min blocks per RTP packet (audio.c:64-110,
        # config 'block = 0-4'); >0 buffers audio and disables the native
        # edge (the Python path owns packet timing then)
        self.agg_blocks = max(0, min(int(cfg.options.get("block", 0)), 4))
        # high-C scalability: groups with C >= big-group channels switch
        # to the scalable host path — lazy info d2h, native edge with
        # squelch-compacted audio, staggered beacon slices bounded by
        # beacon-budget encodes/block (the reference's staggered
        # all-channel dump discipline, radio_status.c:59-67)
        self.big_group_c = int(cfg.options.get("big-group", 4096))
        self.beacon_budget = int(cfg.options.get("beacon-budget", 16))
        self._send_prev: dict[str, np.ndarray] = {}
        self._ginfo: dict[str, Any] = {}  # latest per-group info (big groups)
        # big groups' beacon plans (beacon_plan), dropped with the
        # edges and when a channel's STATUS_INTERVAL changes
        self._beacon_plans: dict[str, list] = {}
        self.egress_overflows = 0  # blocks where open channels > egress slots
        self._dyn_ssrcs: set[int] = set()  # lifetime-scan working set
        # restock auto-provisioning (radio_status.c:92-105 ms-create
        # analog): per-class create timestamps + measured restock
        # latency EMA drive pool sizing (create-rate x latency rule)
        self._create_times: dict[str, list[float]] = {}
        self._restock_latency: dict[str, float] = {}
        self._restock_pending: set[str] = set()  # classes queued behind
        # the single in-flight background restock

        enc_name = str(cfg.options.get("encoding", "s16be")).upper()
        default_enc = Encoding[enc_name] if enc_name in Encoding.__members__ else Encoding.S16BE

        self.chans: dict[int, _Chan] = {}
        for gname, g in self.engine.groups.items():
            spec = g.spec
            out_rate, nch = _out_format(spec)
            genc = default_enc
            if spec.encoding and spec.encoding.upper() in Encoding.__members__:
                genc = Encoding[spec.encoding.upper()]  # per-section override
            for i, c in enumerate(spec.channels):
                ssrc = c.resolved_ssrc()
                while ssrc in self.chans:  # collision: bump like the reference
                    ssrc += 1
                pt = self.registry.pt_from_info(out_rate, nch, genc)
                self.chans[ssrc] = _Chan(
                    group=gname, idx=i, ssrc=ssrc, freq=c.freq, low=c.low,
                    high=c.high, samprate=out_rate, channels=nch,
                    encoding=genc, pt=pt, update_every=spec.update,
                )
                if spec.demod == "wfm" and _yes(cfg.options.get("rds", "n")):
                    # companion RDS-baseband stream on ssrc+1 (the rdsd client's
                    # input); bump on collision like primary channels
                    rds_ssrc = ssrc + 1
                    while rds_ssrc in self.chans:
                        rds_ssrc += 1
                    rds_pt = self.registry.pt_from_info(48_000, 1, Encoding.F16LE)
                    self.chans[rds_ssrc] = _Chan(
                        group=gname, idx=i, ssrc=rds_ssrc, freq=c.freq, low=c.low,
                        high=c.high, samprate=48_000, channels=1,
                        encoding=Encoding.F16LE, pt=rds_pt, rds=True,
                    )

        self.data_sock = self.status_sock = self.status_in = None
        self.beacon_sock = None
        self.edges: dict[str, tuple[Any, list[_Chan]]] = {}
        if use_network:
            ttl = int(cfg.options.get("ttl", 1))
            data_dest = resolve_dest(cfg.options.get("data", "127.0.0.1"), data_port, self._use_dns)
            stat_dest = resolve_dest(cfg.options.get("status", "127.0.0.1"), status_port, self._use_dns)
            # ONE unconnected socket for audio AND per-channel beacons:
            # stock clients (pcmrecord) match data<->status sessions by the
            # sender's source PORT, like the reference's shared Output_fd
            tos = int(self.cfg.options.get("tos", 46 << 2))
            iface = self.cfg.options.get("iface") or None
            self.data_sock = output_socket_unconnected(data_dest, ttl, tos, iface)
            self._global_ttl = ttl
            self._data_ttl_now = ttl
            self._data_dest = data_dest
            self._beacon_dest = (data_dest[0], DEFAULT_STAT_PORT)
            self.status_sock = output_socket(stat_dest, ttl, tos, iface)
            self.beacon_sock = self.data_sock
            self.status_in = listen_socket(stat_dest)
            if (self.agg_blocks == 0
                    and str(cfg.options.get("native-edge", "y")).lower() not in ("n", "no", "false", "0")):
                self._setup_native_edges(data_dest, ttl)
            # RTCP on the data address's next port (rtp.h:7-10)
            self.rtcp_sock = output_socket_unconnected((data_dest[0], data_dest[1] + 1), ttl, tos, iface)
            # SAP/SDP session announcements (radio.c:1244-1366)
            self.sap = None
            self._sap_dest = data_dest
            self._sap_ttl = ttl
            if str(cfg.options.get("sap", "y")).lower() not in ("n", "no", "false", "0"):
                try:
                    from ..net.sap import SapAnnouncer
                    self.sap = SapAnnouncer(ttl)
                except Exception:
                    self.sap = None
            # mDNS service advertisement (avahi.c analog; 'advertise = no' off)
            self.mdns = None
            if str(cfg.options.get("advertise", "y")).lower() not in ("n", "no", "false", "0"):
                try:
                    from ..net.mdns import MdnsAdvertiser, SVC_CTL, SVC_RTP
                    inst = str(cfg.options.get("description", "radiod-tpu")).replace(".", "-")
                    self.mdns = MdnsAdvertiser()
                    self.mdns.add_service(SVC_CTL, inst, stat_dest[1],
                                          {"status": cfg.options.get("status", ""),
                                           "addr": stat_dest[0]})
                    self.mdns.add_service(SVC_RTP, inst + "-pcm", data_dest[1],
                                          {"data": cfg.options.get("data", ""),
                                           "addr": data_dest[0]})
                    # per-section `data =` streams get their own records
                    # (radio.c:755-767 advertises each section's group)
                    for gname, g in self.engine.groups.items():
                        if g.spec.data:
                            gd, _ = self._group_data_dest(gname)
                            self.mdns.add_service(
                                SVC_RTP, f"{inst}-{gname}", gd[1],
                                {"data": g.spec.data, "addr": gd[0]})
                    self.mdns.start()
                except Exception:
                    self.mdns = None
        self._sent: list[tuple[str, bytes]] = []  # (kind, pkt) when offline
        self.output_errors = 0  # failed data sends (chan->output.errors)
        # [global] prealloc = <preset names>: build those dyn groups with
        # dyn-slots tombstoned spares at startup, so the first dynamic
        # creates in each preset never pay a rebuild (the reference
        # creates channels in ms, radio_status.c:92-105)
        for pname in str(cfg.options.get("prealloc", "")).split():
            self._prealloc(pname.lower())

    @staticmethod
    def _feeder(d: dict):
        """The host front end of a file or RTP `[hardware]` section."""
        from .frontends import FileSource, RtpSource

        d = dict(d)
        kind = d.pop("kind")
        return FileSource(**d) if kind == "file" else RtpSource(**d)

    def _init_siggen(self, gen1: Callable) -> None:
        """self._siggen from gen1 (state -> (state, one block)): one block a
        dispatch, or with `time-shards = D` D consecutive ones stacked."""
        if not self._time_shards:
            self._siggen = gen1
            return
        D = self._time_shards

        def _gen(st):
            blocks = []
            for _ in range(D):
                st, blk = gen1(st)
                blocks.append(blk)
            return st, torch.stack(blocks)

        self._siggen = _gen

    def _init_multi_sources(self, cfg) -> None:
        """Front ends of several `[hardware]` sections (the JAX daemon's
        _init_multi_sources): sig_gen sections stack into [B, L] blocks (a
        [D, B, L] dispatch with time-shards); file and RTP sections read per
        stream on the host, and the first one takes the front-end commands;
        sections of neither kind leave the blocks to an external feeder
        (step_block(block=[B, L])). sig_gen and host feeders do not mix."""
        srcs = list(cfg.sources)
        if all(s is not None and not isinstance(s, dict) for s in srcs):
            L = self.engine.L
            self.source_state = [siggen_init(s, device=self.device) for s in srcs]

            def gen1(states):
                outs = [siggen_block(s, st, L) for s, st in zip(srcs, states)]
                return [o[0] for o in outs], torch.stack([o[1] for o in outs])

            self._init_siggen(gen1)
            return
        if any(s is not None and not isinstance(s, dict) for s in srcs):
            raise NotImplementedError(
                "multi-front-end configs cannot mix sig_gen with host "
                "feeders (file/rtp); use one kind per daemon")
        if all(s is None for s in srcs):
            return  # an external feeder drives step_block(block=[B, L])
        if any(s is None for s in srcs):
            raise NotImplementedError(
                "multi-front-end: either every hardware section has a "
                "feeder or an external caller supplies [B, L] blocks")
        self.frontends = [self._feeder(s) for s in srcs]
        self.frontend = self.frontends[0]  # RF_GAIN etc. commands act on the first

    def _mk_step(self, eng) -> Any:
        """The per-dispatch function: the engine's step, or with
        `time-shards = D` a loop of D steps whose outputs stack to [D, ...]
        (the same values as D single steps), or on a mesh step_time."""
        if not self._time_shards:
            return eng.step
        if self._mesh is not None:
            return eng.step_time
        D = self._time_shards

        def step_many(state, prms, blocks):
            outs = []
            for d in range(D):
                state, out = eng.step(state, prms, blocks[d])
                outs.append(out)
            return state, _stack_tree(outs)

        return step_many

    def _prealloc(self, preset: str):
        from ..config.loader import _build_group
        from ..config.presets import preset_table

        presets = preset_table()
        if preset not in presets or self.dyn_spare == 0:
            return
        template = _build_group(f"dyn-{preset}", dict(presets[preset]), [(0.0, 0.0)])
        gname = self._group_for_spec(template, default=template.name)
        if self.free_slots.get(gname):
            return  # the matching class already holds spare slots
        template = dataclasses.replace(template, name=gname)
        slot = self._acquire_slot(gname, template)
        self._mute_slot(gname, slot)
        self.free_slots.setdefault(gname, []).append(slot)

    def _setup_native_edges(self, data_dest, ttl: int):
        """Batched C++ RTP output (native/rtp_edge.cpp): one sendmmsg per
        group per block instead of per-channel Python sendto loops. PCM
        encodings, and Opus where the edge was built with libopus. A group
        left without its edge runs the O(C) Python path, which cannot keep
        up with a big group, so a failure here is said on stderr."""
        from ..native import RtpEdge, native_available, native_has_opus

        if not native_available():
            print("native edge unavailable (g++ or the build of native/rtp_edge.cpp "
                  "failed): RTP goes out through the Python path", file=sys.stderr, flush=True)
            return
        edge_opus = native_has_opus()
        for gname, g in self.engine.groups.items():
            spec = g.spec
            if spec.demod == "spectrum":
                continue
            if spec.egress_slots and any(
                    c.encoding in (Encoding.OPUS, Encoding.OPUS_VOIP)
                    for c in self.chans.values() if c.group == gname):
                # the compacted (indexed) send is PCM-only: Opus needs
                # per-channel encoder state the gather path doesn't carry
                continue
            if spec.demod == "wfm":
                # WFM flips channel count and payload type per block on pilot
                # loss (wfm.c:226-276), which the fixed-shape edge cannot;
                # station counts are small, the Python path handles them
                # (and their RDS companion streams)
                continue
            group_chans = [c for c in self.chans.values()
                           if c.group == gname
                           and (edge_opus or c.encoding not in (Encoding.OPUS, Encoding.OPUS_VOIP))
                           and c.dest_sock is None and not (c.maxdelay or 0)]
            if len(group_chans) != g.C:
                continue
            group_chans.sort(key=lambda c: c.idx)
            nch = group_chans[0].channels
            gdest, gttl = self._group_data_dest(gname)
            try:
                edge = RtpEdge(gdest, C=g.C, nch=nch,
                               ttl=gttl if gttl is not None else ttl)
            except OSError as e:
                print(f"[{gname}] native edge to {gdest} failed ({e}): RTP goes out "
                      "through the Python path", file=sys.stderr, flush=True)
                continue
            edge.ssrc[:] = [c.ssrc for c in group_chans]
            edge.pt[:] = [c.pt for c in group_chans]
            edge.encoding[:] = [int(c.encoding) for c in group_chans]
            edge.samprate[:] = [c.samprate for c in group_chans]
            edge.opus_bitrate[:] = [c.opus_bitrate for c in group_chans]
            edge.opus_dtx[:] = [1 if c.opus_dtx else 0 for c in group_chans]
            edge.opus_app[:] = [c.opus_app or 0 for c in group_chans]
            self.edges[gname] = (edge, group_chans)

    def _refresh_edges(self):
        """Rebuild the native sendmmsg edges after the channel table or a
        channel's encoding/redirect/aggregation settings changed."""
        self._group_dests.clear()
        self._send_prev.clear()  # per-group [C] shapes may have changed
        self._beacon_plans.clear()
        self._ginfo.clear()
        if not self.edges and self.data_sock is None:
            return
        for edge, _ in self.edges.values():
            edge.close()
        self.edges = {}
        if self.data_sock is not None and self.agg_blocks == 0 and str(
                self.cfg.options.get("native-edge", "y")).lower() not in ("n", "no", "false", "0"):
            ttl = int(self.cfg.options.get("ttl", 1))
            data_dest = resolve_dest(self.cfg.options.get("data", "127.0.0.1"), self._data_port)
            self._setup_native_edges(data_dest, ttl)

    # ------------------------------------------------------------------ IO
    def _group_data_dest(self, gname: str):
        """Target for a group's RTP: its own `data =` stream when the
        section sets one (radio.c:705-754), else the [global] data group.
        All sends still leave the ONE unconnected data socket (same source
        port — the session-matching discipline stock clients rely on)."""
        d = self._group_dests.get(gname)
        if d is None:
            spec = self.engine.groups[gname].spec
            d = ((resolve_dest(spec.data, self._data_port, self._use_dns)
                  if spec.data else self._data_dest), spec.ttl)
            self._group_dests[gname] = d
        return d

    def _set_data_ttl(self, ttl: "int | None"):
        """Per-section `ttl =` on the shared data socket (the reference
        splits ttl==0 loopback-only streams onto a second fd,
        radio_status.c:124; one socket + setsockopt keeps our source-port
        discipline intact)."""
        import socket as _socket
        want = ttl if ttl is not None else self._global_ttl
        if want != self._data_ttl_now:
            self.data_sock.setsockopt(_socket.IPPROTO_IP, _socket.IP_MULTICAST_TTL, want)
            self._data_ttl_now = want

    @staticmethod
    def _edge_src_addr(edge):
        """(addr, port) a native edge's packets leave from (cached)."""
        src = getattr(edge, "_src_addr", None)
        if src is None:
            import os as _os
            import socket as _socket
            try:
                s = _socket.socket(fileno=_os.dup(edge.fd))
                src = s.getsockname()[:2]
                s.close()
            except OSError:
                src = ()
            edge._src_addr = src
        return src

    def _send_data(self, pkt: bytes, sock=None, group: "str | None" = None):
        if sock is not None:  # per-channel OUTPUT_DATA_DEST redirect
            try:
                sock.send(pkt)
            except OSError:
                pass
            return
        if self.data_sock is not None:
            dest, ttl = (self._group_data_dest(group) if group
                         else (self._data_dest, None))
            try:
                self._set_data_ttl(ttl)
                self.data_sock.sendto(pkt, dest)
            except OSError:
                self.output_errors += 1
        else:
            self._sent.append(("data", pkt))

    def _send_status(self, pkt: bytes, ch: "_Chan | None" = None):
        """Poll/command responses: the control group AND the output
        stream's status port (radio.c response() sends both). The beacon
        copy rides the channel's data source socket so stock clients can
        keep correlating sessions by source port."""
        if self.status_sock is not None:
            try:
                self.status_sock.send(pkt)
            except OSError:
                pass
            self._send_beacon(pkt, ch)
        else:
            self._sent.append(("status", pkt))

    def _send_beacon(self, pkt: bytes, ch: "_Chan | None" = None):
        """Per-channel beacons: the data group's status port, from the
        SAME source socket (and port) as the channel's audio."""
        if ch is not None and ch.group in self.edges:
            edge, _ = self.edges[ch.group]
            if edge.send_ctl(pkt, DEFAULT_STAT_PORT) >= 0:
                return
        if self.beacon_sock is not None:
            dest = self._beacon_dest
            if ch is not None and ch.group in self.engine.groups:
                gdest, _ = self._group_data_dest(ch.group)
                dest = (gdest[0], DEFAULT_STAT_PORT)
            try:
                self.beacon_sock.sendto(pkt, dest)
            except OSError:
                pass
        elif self.status_sock is None:
            self._sent.append(("status", pkt))

    # ------------------------------------------------------------- control
    def poll_commands(self, budget: int = 16):
        """Drain pending control packets (radio_status.c:38-111). An error
        while applying one propagates: nothing here is a transient flake."""
        if self.status_in is None:
            return
        for _ in range(budget):
            r, _, _ = select.select([self.status_in], [], [], 0)
            if not r:
                return
            try:
                pkt, _addr = self.status_in.recvfrom(65536)
            except OSError:
                return
            self.handle_packet(pkt)

    def handle_packet(self, pkt: bytes):
        try:
            ptype, fields, _ = decode_status(pkt)
        except Exception:
            return
        if ptype != PacketType.CMD:
            return  # ignore other radiods' status (radio_status.c:52-57)
        ssrc = fields.get(T.OUTPUT_SSRC)
        tag = fields.get(T.COMMAND_TAG, 0)
        if ssrc is None:
            return
        if ssrc == 0xFFFFFFFF:  # all-channel dump
            for ch in list(self.chans.values()):
                self._send_status(self.encode_channel_status(ch, tag), ch)
            return
        ch = self.chans.get(ssrc)
        if ch is None:
            ch = self.create_dynamic_channel(ssrc, fields)
            if ch is None:
                return
        ch.commands += 1
        if ch.dynamic and ch.lifetime_init:
            ch.lifetime = ch.lifetime_init  # poll/command restarts the countdown
        self._arm_spectrum(ch)
        self.apply_command(ch, fields)
        # geometry commands can relocate the channel into a fresh group
        # class — re-arm under the group it landed in
        self._arm_spectrum(ch)
        g = self.engine.groups.get(ch.group)
        if (g is not None and g.spec.demod == "spectrum"
                and not self._spectrum_bins_ready(ch)):
            # the reference responds to a spectrum poll only AFTER running
            # the FFT it just armed (spectrum.c:64-66: response() sits at
            # the top of the next loop pass) — defer ours the same way so
            # single-shot pollers get bins in the first response
            self._deferred_status.append((ssrc, tag))
            return
        self._send_status(self.encode_channel_status(ch, tag), ch)

    # ------------------------------------------------ lazy spectrum gating
    def _set_spectrum_armed(self, gname: str, armed: bool) -> None:
        """Flip one spectrum group's `armed` param (host mirror and the
        device scalar, in place)."""
        g = self.engine.groups[gname]
        if "armed" not in g.host or bool(g.host["armed"]) == armed:
            return
        self.engine.set_armed(self.params, gname, armed)

    def _sync_spectrum_lazy(self) -> None:
        """(Re)apply the armed flags after engine construction/rebuild:
        lazy groups are disarmed unless a live arming window says
        otherwise (fresh engines come up armed by default)."""
        for gname, g in self.engine.groups.items():
            if g.spec.demod != "spectrum" or not g.spec.spectrum_lazy:
                continue
            self._set_spectrum_armed(gname, gname in self._spectrum_armed)

    def _arm_spectrum(self, ch: "_Chan") -> None:
        """A poll/command touched `ch`: arm its group for idle-timeout
        seconds (spectrum.c computes bins only on response_needed; ours
        accumulates while the arming window is open)."""
        g = self.engine.groups.get(ch.group)
        if g is None or g.spec.demod != "spectrum" or not g.spec.spectrum_lazy:
            return
        idle = max(1, int(g.spec.spectrum_idle_s / self.cfg.blocktime))
        armed_at, _ = self._spectrum_armed.get(ch.group, (self.blocks, 0))
        self._spectrum_armed[ch.group] = (armed_at, self.blocks + idle)
        self._set_spectrum_armed(ch.group, True)

    def _decay_spectrum(self) -> None:
        """Disarm lazy spectrum groups whose arming window expired."""
        for gname, (_, until) in list(self._spectrum_armed.items()):
            if self.blocks >= until:
                del self._spectrum_armed[gname]
                self._set_spectrum_armed(gname, False)

    def _spectrum_bins_ready(self, ch: "_Chan") -> bool:
        """BIN_DATA belongs in a status packet only when the sweep has
        actually accumulated: always-on groups always have it; lazy groups
        need an open arming window with >= 1 block run inside it."""
        g = self.engine.groups.get(ch.group)
        if g is None or not g.spec.spectrum_lazy:
            return True
        win = self._spectrum_armed.get(ch.group)
        return win is not None and self.blocks > win[0]

    # ------------------------------------------------ dynamic channel table
    def _setp(self, gname: str, idx: int, key: str, value):
        """One demod-param write: the host mirror and the channel's row of
        the device param, in place."""
        self.engine.groups[gname].set_demod(self.params[gname], idx, key, value)

    # keys the mute sentinel occupies; the single source of truth for
    # tombstoning, park snapshots, and park-aware user writes
    _MUTE_SENTINEL = {"squelch_open": np.float32(1e30),
                      "squelch_close": np.float32(1e30),
                      "snr_squelch_enable": True,
                      "manual_gain": 0.0}
    _MUTE_KEYS = tuple(_MUTE_SENTINEL)

    def _setp_many(self, gname: str, idx: int, items: dict):
        """_setp for several keys."""
        for key, value in items.items():
            self._setp(gname, idx, key, value)

    def _setp_user(self, ch: "_Chan", key: str, value):
        """User-facing param write: a PARKED channel's mute sentinel must
        survive, so writes to the muted keys land in the park snapshot and
        take effect on unpark."""
        if ch.parked and key in self._MUTE_KEYS:
            self._park_saves.setdefault((ch.group, ch.idx), {})[key] = value
            return
        self._setp(ch.group, ch.idx, key, value)

    def _mute_slot(self, gname: str, idx: int):
        """Tombstone one slot (radio.c:1465-1471 analog): squelch forced
        shut + zero gain via params surgery, so a freed slot costs nothing
        until reused."""
        self._setp_many(gname, idx, self._MUTE_SENTINEL)

    def _restore_slot(self, gname: str, slot: int):
        """Un-tombstone: restore the slot's demod params from the group's
        pristine build-time defaults."""
        g0 = self.engine.groups[gname]
        self._setp_many(gname, slot, {
            key: arr[min(slot, arr.shape[0] - 1)]
            for key, arr in g0.pristine_demod.items()})

    def _acquire_slot(self, gname: str, template) -> int:
        """Get a live slot in group `gname` (created from `template` if the
        group is absent). A tombstoned slot is reused with pure params
        surgery (milliseconds); otherwise the channel table rebuilds with
        `dyn-slots` EXTRA pre-tombstoned spares so subsequent creates need
        no rebuild — the latency analog of the reference's
        always-resident channel table (radio_status.c:92-105, radio.h:344).
        When the pool runs low a background restock (_schedule_restock)
        grows it off the command path."""
        import time as _time

        self._create_times.setdefault(gname, []).append(_time.monotonic())
        if self.free_slots.get(gname):
            slot = self.free_slots[gname].pop()
            self._restore_slot(gname, slot)
            # auto-provisioning (VERDICT r5 #7): restock when the pool
            # drops below what the measured create rate would drain in
            # one measured restock latency (x1.5 margin), and never later
            # than half-empty — restocks serialize across classes, so a
            # late trigger plus two queued grows drains a pool to zero
            # (the provisioning rule OPERATIONS.md states, at runtime)
            floor = max(1, self.dyn_spare // 2, self._pool_need(gname))
            if len(self.free_slots[gname]) <= floor:
                self._schedule_restock(gname)
            return slot
        if gname in self.engine.groups and self.blocks > 0:
            # the pool emptied: this create pays a FOREGROUND rebuild —
            # surface the provisioning shortfall with the measured terms
            rate, lat = self._class_rate(gname), self._restock_latency.get(gname, 0.0)
            print(f"dyn pool [{gname}] empty: foreground rebuild "
                  f"(create rate {rate:.2f}/s x restock {lat:.0f}s needs "
                  f"~{self._pool_need(gname)} spares; dyn-slots={self.dyn_spare})",
                  file=sys.stderr, flush=True)
        spare = self.dyn_spare
        # under a mesh, group channel counts stay divisible by the device
        # count: the added slots round up (the extras become spares)
        mult = self._mult()
        _t0 = _time.monotonic()
        if gname not in self.engine.groups:
            count = -((1 + spare) // -mult) * mult
            ch0 = template.channels[0]
            spec = dataclasses.replace(template, name=gname,
                                       channels=(ch0,) * count)
            self._rebuild(list(self.engine.specs) + [spec])
            slot, extra = 0, range(1, count)
        else:
            g = self.engine.groups[gname]
            spec = g.spec
            count = -((g.C + 1 + spare) // -mult) * mult - g.C
            new_spec = dataclasses.replace(
                spec, channels=spec.channels + (spec.channels[-1],) * count)
            self._rebuild([new_spec if s.name == gname else s for s in self.engine.specs])
            slot, extra = g.C, range(g.C + 1, g.C + count)
        # seed the class's restock-latency estimate from this foreground
        # rebuild so provisioning adapts before the first background grow;
        # the EMA corrects it once real grows land
        self._restock_latency.setdefault(gname, _time.monotonic() - _t0)
        for s in extra:
            self._mute_slot(gname, s)
        self.free_slots.setdefault(gname, []).extend(extra)
        return slot

    _RATE_WINDOW = 120.0  # seconds of create history for the rate estimate

    def _class_rate(self, gname: str) -> float:
        """Recent slot-acquisition rate for one class, 1/s."""
        import time as _time

        now = _time.monotonic()
        times = self._create_times.get(gname, [])
        keep = [t for t in times if now - t <= self._RATE_WINDOW]
        self._create_times[gname] = keep
        if len(keep) < 2:
            return 0.0
        span = max(now - keep[0], 1.0)
        return len(keep) / span

    def _pool_need(self, gname: str) -> int:
        """Spare slots this class should hold: create-rate x measured
        restock latency x 1.5 margin (docs/OPERATIONS.md provisioning
        rule, applied at runtime). 0 until both terms are measured."""
        lat = self._restock_latency.get(gname, 0.0)
        if lat <= 0.0:
            return 0
        return int(np.ceil(self._class_rate(gname) * lat * 1.5))

    @staticmethod
    def _spec_key(spec) -> tuple:
        """Group identity = every GroupSpec field except name/channels —
        and except `update`, which only seeds each static channel's beacon
        cadence and must not keep a dynamic create out of a matching class
        (data/ttl DO stay: they change where the group's shared edge
        sends)."""
        d = dataclasses.asdict(spec)
        d.pop("name")
        d.pop("channels")
        d.pop("update", None)
        return tuple(sorted((k, repr(v)) for k, v in d.items()))

    def _group_for_spec(self, template, default: str | None = None) -> str:
        """Existing group whose class matches `template` — static groups
        included, so dynamic creates and moves reuse their groups (and any
        tombstoned spares) instead of building a parallel
        dyn group. Otherwise `default`, else a canonical dyn~ name derived
        from the spec fields (so repeat moves to the same class share one
        group)."""
        key = self._spec_key(template)
        for name, g in self.engine.groups.items():
            if self._spec_key(g.spec) == key:
                return name
        if default is not None:
            return default
        import zlib
        return "dyn~%08x" % zlib.crc32(repr(key).encode())

    # runtime params carried across a demod-preserving move (the reference
    # mutates one struct field and restarts the demod in place, keeping the
    # rest of the channel's settings)
    _CARRY_KEYS = ("squelch_open", "squelch_close", "snr_squelch_enable",
                   "manual_gain", "agc_enable", "hangtime_samples",
                   "recovery_per_sample", "threshold", "headroom",
                   "tone_freq", "shift_inc_q32", "pll_loop_bw", "pll_square",
                   "threshold_ext", "deemph_rate", "deemph_gain")

    def _move_channel(self, ch: _Chan, template, carry: bool = True,
                      low: float | None = None, high: float | None = None):
        """Relocate a channel to the group matching `template` — the analog
        of decode_radio_commands' restart path (PRESET/DEMOD_TYPE/
        OUTPUT_SAMPRATE/ISB/..., radio_status.c:167-264): the old slot
        tombstones, a slot in the target rate class is acquired (params
        surgery when one is free, a table rebuild otherwise), and tuning
        plus (optionally) the channel's runtime params are re-applied."""
        old_g, old_i = ch.group, ch.idx
        # the output stream sticks to the channel across restarts, like
        # chan->output.dest_socket in the reference
        old_spec = self.engine.groups[old_g].spec
        template = dataclasses.replace(
            template, data=old_spec.data, ttl=old_spec.ttl)
        gname = self._group_for_spec(template)
        lo = low if low is not None else ch.low
        hi = high if high is not None else ch.high
        if gname == old_g:
            if not carry:  # PRESET re-applied onto the same class: reload defaults
                if ch.parked:
                    g0 = self.engine.groups[gname]
                    self._park_saves[(gname, old_i)] = {
                        k: np.copy(arr[min(old_i, arr.shape[0] - 1)])
                        for k, arr in g0.pristine_demod.items()
                        if k in self._MUTE_KEYS}
                    for k, arr in g0.pristine_demod.items():
                        if k not in self._MUTE_KEYS:
                            self._setp(gname, old_i, k, arr[min(old_i, arr.shape[0] - 1)])
                else:
                    self._restore_slot(gname, old_i)
            self.params = self.engine.set_edges(
                self.params, gname, old_i, lo, hi, ch.kaiser_beta, ch.filter2_beta)
            ch.low, ch.high = min(lo, hi), max(lo, hi)
            return
        carried = {}
        if carry:
            host = self.engine.groups[old_g].host["demod"]
            carried = {k: np.copy(host[k][old_i]) for k in self._CARRY_KEYS if k in host}
            # a parked channel's pre-mute values are the real ones to carry
            for k, v in self._park_saves.get((old_g, old_i), {}).items():
                if k in carried:
                    carried[k] = np.copy(v)
        self._park_saves.pop((old_g, old_i), None)
        self._mute_slot(old_g, old_i)
        self.free_slots.setdefault(old_g, []).append(old_i)
        slot = self._acquire_slot(gname, dataclasses.replace(template, name=gname))
        spec = self.engine.groups[gname].spec
        ch.group, ch.idx = gname, slot
        ch.last_info = {}  # stale per-group info from the old class
        ch.agg = []
        out_rate, ch.channels = _out_format(spec)
        ch.samprate = out_rate
        ch.pt = self.registry.pt_from_info(out_rate, ch.channels, ch.encoding)
        ch.opus_encoder = None
        lo = max(lo, -out_rate / 2)
        hi = min(hi, out_rate / 2)
        # carried runtime params FIRST: if the final retune parks the new
        # slot, the park snapshot must hold these (not pristine defaults),
        # and the mute sentinel must stay on top
        for k, v in carried.items():
            self._setp(gname, slot, k, v)
        self.params = self.engine.set_edges(
            self.params, gname, slot, lo, hi, ch.kaiser_beta, ch.filter2_beta)
        ch.low, ch.high = min(lo, hi), max(lo, hi)
        ch.parked = False  # fresh slot: _retune re-parks if still uncovered
        self._retune(ch, ch.freq)
        self._refresh_edges()

    def round_samprate(self, r: int) -> int:
        """Force an output rate commensurate with the master geometry (both
        N*r and L*r must divide the input rate) — the analog of
        modes.c:525-542's multiple-of-blockrate rule."""
        import math
        fs = int(round(self.engine.samprate))
        N, L = self.engine.master.N, self.engine.master.L
        base = math.lcm(fs // math.gcd(fs, N), fs // math.gcd(fs, L))
        return max(base, int(round(r / base)) * base)

    def create_dynamic_channel(self, ssrc: int, fields: dict) -> "_Chan | None":
        """Unknown SSRC command -> create the channel (radio_status.c:92-105).

        A dynamic channel lands in the group "dyn-<preset>": a tombstoned
        (freed or preallocated) slot is reused with pure params surgery;
        otherwise the channel table is rebuilt `dyn-slots` larger, with
        every other channel's carried state and runtime
        params migrated (engine.migrate_state).
        """
        from ..config.loader import _build_group
        from ..config.presets import preset_table

        presets = preset_table()
        preset = str(fields.get(T.PRESET, "") or self.default_mode).lower()
        if preset not in presets:
            return None
        freq = float(fields.get(T.RADIO_FREQUENCY, 0.0) or 0.0)
        template = _build_group(f"dyn-{preset}", dict(presets[preset]), [(freq, 0.0)])
        # reuse any group already built for this class (static ones
        # included — the reference has one flat channel table, radio.c)
        gname = self._group_for_spec(template, default=template.name)
        template = dataclasses.replace(template, name=gname)
        slot = self._acquire_slot(gname, template)

        spec = self.engine.groups[gname].spec
        out_rate, nch = _out_format(spec)
        enc_name = str(self.cfg.options.get("encoding", "s16be")).upper()
        enc = Encoding[enc_name] if enc_name in Encoding.__members__ else Encoding.S16BE
        pt = self.registry.pt_from_info(out_rate, nch, enc)
        tch = template.channels[0]  # preset edges, not the host group's
        ch = _Chan(group=gname, idx=slot, ssrc=ssrc, freq=freq,
                   low=tch.low, high=tch.high,
                   samprate=out_rate, channels=nch, encoding=enc, pt=pt,
                   dynamic=True, lifetime=self.lifetime_blocks,
                   lifetime_init=self.lifetime_blocks, preset=preset)
        self.chans[ssrc] = ch
        self._dyn_ssrcs.add(ssrc)
        self._retune(ch, freq)
        self.params = self.engine.set_edges(self.params, gname, slot, ch.low, ch.high)
        return ch

    def remove_channel(self, ssrc: int):
        """Tombstone an idle dynamic channel: mute the slot and recycle it
        for the next dynamic create — nothing rebuilt."""
        ch = self.chans.pop(ssrc, None)
        self._dyn_ssrcs.discard(ssrc)
        if ch is None:
            return
        self._park_saves.pop((ch.group, ch.idx), None)
        if ch.dest_sock is not None:
            try:
                ch.dest_sock.close()
            except OSError:
                pass
        self._mute_slot(ch.group, ch.idx)
        self.free_slots.setdefault(ch.group, []).append(ch.idx)

    def _rebuild(self, specs):
        """Channel-table change: a new engine, with the carried state
        (migrate_state) and the commands' host params (adopt_host_params)
        moved across. The new engine, state and params are built into
        locals first and swapped in together, so an error (a demodulator
        the port does not carry, say) leaves the old ones intact and
        propagates."""
        old = self.engine
        new_eng = Engine(groups=specs, **self._engine_kwargs())
        new_state = migrate_state(self.state, new_eng.init_state())
        new_params = new_eng.adopt_host_params(old)
        self.state = new_state
        self.params = new_params
        self.engine = new_eng
        self.step = self._mk_step(new_eng)
        self._engine_epoch += 1  # void any in-flight background restock
        self._sync_spectrum_lazy()  # fresh engines come up armed
        self._group_dests.clear()
        if self.edges:
            self._refresh_edges()

    def _mult(self) -> int:
        """The multiple every group's channel count keeps: the mesh size
        (a channel-sharded engine needs it), else 1."""
        return self._mesh.size if self._mesh is not None else 1

    # ------------------------------------------------ background restock
    def _engine_kwargs(self) -> dict:
        return dict(
            samprate=self.cfg.samprate, real=self.cfg.real,
            blocktime=self.cfg.blocktime, overlap=self.cfg.overlap,
            spurs=self._spurs, n_inputs=self._n_inputs,
            center=(self.cfg.centers if self._n_inputs > 1 else getattr(self.cfg, "center", 0.0)),
            fft=str(self.cfg.options.get("fft", "auto")).lower(),
            fft_precision=str(self.cfg.options.get("fft-precision", "high")).lower(),
            use_matmul=_yes(self.cfg.options.get("matmul", "n")),
            noise_every=self._noise_every, device=self.device, mesh=self._mesh,
            time_shards=self._time_shards if self._mesh is not None else 0)

    def _schedule_restock(self, gname: str):
        """Grow a dynamic class's pool of spare slots OFF the command path:
        a worker thread builds the grown engine (its params and the
        channelizer operand go to the card on a side CUDA stream of their
        own), and step_block swaps it in at a block boundary
        (migrate_state + adopt_host_params, both cheap). A foreground
        _rebuild meanwhile (epoch bump) voids the result. An error in the
        worker is raised at the swap."""
        if self.dyn_spare == 0:
            return
        if self._restock is not None:
            # one restock builds at a time; remember the demand so the
            # next class's grow starts the moment this one lands
            self._restock_pending.add(gname)
            return
        if gname not in self.engine.groups:
            return
        import threading
        import time as _time

        g = self.engine.groups[gname]
        # size the new pool to demand: at least dyn-slots, more when the
        # measured create rate x restock latency projects a deeper drain
        want = max(self.dyn_spare, self._pool_need(gname), 1)
        mult = self._mult()
        count = -((g.C + want) // -mult) * mult - g.C
        specs = [dataclasses.replace(s, channels=s.channels + (s.channels[-1],) * count)
                 if s.name == gname else s for s in self.engine.specs]
        kwargs = self._engine_kwargs()
        r: dict[str, Any] = {"gname": gname, "epoch": self._engine_epoch,
                             "count": count, "error": None, "C": g.C,
                             "t0": _time.monotonic()}
        dev = self.device

        def work():
            try:
                if dev.type == "cuda":
                    side = torch.cuda.Stream(device=dev)
                    with torch.cuda.stream(side):
                        r["engine"] = Engine(groups=specs, **kwargs)
                    # the worker waits for its own copies; the loop never does
                    side.synchronize()
                else:
                    r["engine"] = Engine(groups=specs, **kwargs)
            except Exception as e:
                r["error"] = e

        r["thread"] = threading.Thread(target=work, daemon=True,
                                       name=f"restock-{gname}")
        self._restock = r
        r["thread"].start()

    def _finish_restock(self, wait: bool = False):
        """Swap in a completed background restock (block-boundary safe: the
        previous dispatch's device->host copy has synchronised the loop's
        stream, so no step still reads the old engine's tensors)."""
        r = self._restock
        if r is None:
            # the slot is free: start the next queued class's grow (its
            # request arrived while another restock was building)
            while self._restock_pending and self._restock is None:
                g = self._restock_pending.pop()
                if (g in self.engine.groups
                        and len(self.free_slots.get(g, ()))
                        <= max(1, self.dyn_spare // 2, self._pool_need(g))):
                    self._schedule_restock(g)
            return
        if wait:
            r["thread"].join()
        if r["thread"].is_alive():
            return
        self._restock = None
        if r["error"] is not None:
            raise r["error"]
        if r["epoch"] != self._engine_epoch:
            return  # a foreground rebuild superseded this engine
        old = self.engine
        new_eng = r["engine"]
        gname, count, old_C = r["gname"], r["count"], r["C"]
        new_state = migrate_state(self.state, new_eng.init_state())
        new_params = new_eng.adopt_host_params(old)
        self.state, self.params, self.engine = new_state, new_params, new_eng
        self.step = self._mk_step(new_eng)
        # measured restock latency drives the auto-provisioning rule
        lat = time.monotonic() - r["t0"]
        prev = self._restock_latency.get(gname)
        self._restock_latency[gname] = (lat if prev is None
                                        else prev + 0.3 * (lat - prev))
        self._engine_epoch += 1
        self._sync_spectrum_lazy()
        self._group_dests.clear()
        for s in range(old_C, old_C + count):
            self._mute_slot(gname, s)
        self.free_slots.setdefault(gname, []).extend(range(old_C, old_C + count))
        if self.edges:
            self._refresh_edges()

    def _retune(self, ch: _Chan, freq: float):
        """Tune a channel, parking it when the frequency is outside
        front-end coverage (radio.c:1472-1498: the reference blocks the
        demod muted until coverage returns; here the slot mutes and the
        requested frequency is remembered — a later in-coverage retune
        unparks it)."""
        try:
            self.params = self.engine.retune(self.params, ch.group, ch.idx, freq)
        except ValueError:
            ch.freq = freq
            if not ch.parked:
                ch.parked = True
                # snapshot what muting overwrites so unparking restores the
                # USER's settings, not the preset defaults
                host = self.engine.groups[ch.group].host["demod"]
                keys = ("squelch_open", "squelch_close", "snr_squelch_enable",
                        "manual_gain")
                self._park_saves[(ch.group, ch.idx)] = {
                    k: np.copy(host[k][ch.idx]) for k in keys if k in host}
                self._mute_slot(ch.group, ch.idx)
            return
        ch.freq = freq
        if ch.parked:
            ch.parked = False
            saved = self._park_saves.pop((ch.group, ch.idx), None)
            if saved:
                for k, v in saved.items():
                    self._setp(ch.group, ch.idx, k, v)
            else:
                self._restore_slot(ch.group, ch.idx)

    def _set_encoding(self, ch: _Chan, code: int):
        """OUTPUT_ENCODING (radio_status.c:572-597): switch the wire
        encoding; Opus forces a legal rate (48 kHz move when needed)."""
        try:
            enc = Encoding(code)
        except ValueError:
            return
        if enc == ch.encoding or enc == Encoding.AX25:
            return
        if enc in (Encoding.OPUS, Encoding.OPUS_VOIP):
            # Opus needs the system libopus (ctypes) or the native edge
            # built with it — reject clearly instead of crashing on the
            # first packet (declared optional-dependency surface)
            from ..net import opus as _opus
            try:
                from ..native import native_has_opus
            except Exception:
                native_has_opus = lambda: False
            if not _opus.available() and not native_has_opus():
                print(f"ssrc {ch.ssrc}: Opus encoding rejected — libopus "
                      "not found (install the system libopus)",
                      file=sys.stderr, flush=True)
                return
        if enc in (Encoding.OPUS, Encoding.OPUS_VOIP) and ch.samprate not in _OPUS_RATES:
            spec = self.engine.groups[ch.group].spec
            if spec.demod == "wfm":
                return  # wfm output is 48k already; anything else is a bug
            self._move_channel(ch, dataclasses.replace(spec, samprate=48_000))
        ch.encoding = enc
        ch.opus_encoder = None
        ch.pt = self.registry.pt_from_info(ch.samprate, ch.channels, enc)
        self._refresh_edges()  # Opus channels leave the native edge

    def _set_dest(self, ch: _Chan, dest):
        """OUTPUT_DATA_DEST_SOCKET (radio_status.c:667-675): per-channel
        RTP redirect; the port is forced to the RTP default like the
        reference. Status keeps flowing on the shared status group."""
        try:
            addr = dest[0] if isinstance(dest, (tuple, list)) else str(dest)
            sock = output_socket((addr, DEFAULT_RTP_PORT), int(self.cfg.options.get("ttl", 1)))
        except OSError:
            return
        if ch.dest_sock is not None:
            try:
                ch.dest_sock.close()
            except OSError:
                pass
        ch.dest_sock = sock
        self._refresh_edges()  # redirected channels leave the native edge

    def apply_command(self, ch: _Chan, fields: dict):
        """decode_radio_commands parity (radio_status.c:133-702).

        PRESET is processed first (the reference's dedicated first pass);
        restart-class keys (DEMOD_TYPE, OUTPUT_SAMPRATE, ISB, PLL_ENABLE,
        ENVELOPE, OUTPUT_CHANNELS on linear, FILTER2, spectrum geometry)
        fold into ONE move to another group class; every other key is pure
        params surgery or host-side state, nothing rebuilt."""
        import math

        eng = self.engine
        spec0 = eng.groups[ch.group].spec
        template = spec0
        carry = True
        low = high = None
        refilter = False

        # ---- pass 1: PRESET (radio_status.c:166-209; spectrum channels
        # never take presets, :688-689) ----
        if T.PRESET in fields and spec0.demod != "spectrum":
            from ..config.loader import _build_group
            from ..config.presets import preset_table

            pname = str(fields[T.PRESET]).lower()
            presets = preset_table()
            if pname in presets:
                template = _build_group("tmp", dict(presets[pname]), [(ch.freq, 0.0)])
                carry = False  # preset overwrites runtime params (loadpreset)
                ch.preset = pname
                ch.kaiser_beta = ch.filter2_beta = None
                low = template.channels[0].low
                high = template.channels[0].high

        # ---- restart-class keys fold into the move template ----
        repl: dict[str, Any] = {}
        if T.DEMOD_TYPE in fields:
            name = {v: k for k, v in DEMOD_TYPE_CODES.items()}.get(int(fields[T.DEMOD_TYPE]))
            if name and name != template.demod:
                repl["demod"] = name
        if (T.OUTPUT_SAMPRATE in fields and repl.get("demod", template.demod) != "wfm"
                and int(fields[T.OUTPUT_SAMPRATE]) > 0):
            r = self.round_samprate(abs(int(fields[T.OUTPUT_SAMPRATE])))
            if ch.encoding in (Encoding.OPUS, Encoding.OPUS_VOIP) and r not in _OPUS_RATES:
                r = 0  # ignore illegal Opus rates (radio_status.c:249)
            if r and r != template.samprate:
                repl["samprate"] = r
        if T.INDEPENDENT_SIDEBAND in fields and repl.get("demod", template.demod) == "linear":
            isb = bool(fields[T.INDEPENDENT_SIDEBAND])
            if isb != template.isb:
                repl["isb"] = isb
                if isb:  # forces stereo output + filter2 on (radio_status.c:355-381)
                    repl["stereo"] = True
                    if template.filter2 == 0:
                        repl["filter2"] = 1
        if T.PLL_ENABLE in fields and repl.get("demod", template.demod) == "linear":
            if bool(fields[T.PLL_ENABLE]) != template.enable_pll:
                repl["enable_pll"] = bool(fields[T.PLL_ENABLE])
        if T.ENVELOPE in fields and repl.get("demod", template.demod) == "linear":
            if bool(fields[T.ENVELOPE]) != template.envelope:
                repl["envelope"] = bool(fields[T.ENVELOPE])
        if T.OUTPUT_CHANNELS in fields:
            nch = int(fields[T.OUTPUT_CHANNELS])
            if (nch in (1, 2) and repl.get("demod", template.demod) == "linear"
                    and (nch == 2) != template.stereo):
                repl["stereo"] = nch == 2  # wfm handled as runtime stereo_enable below
        if T.FILTER2 in fields:
            f2 = abs(int(fields[T.FILTER2]))
            if f2 <= 10 and f2 != template.filter2:
                repl["filter2"] = f2
        if template.demod == "spectrum":
            for key, field, conv in (
                (T.RESOLUTION_BW, "bin_bw", lambda v: abs(float(v))),
                (T.BIN_COUNT, "bin_count", lambda v: abs(int(v))),
                (T.CROSSOVER, "crossover", lambda v: abs(float(v))),
                (T.SPECTRUM_SHAPE, "spectrum_window_param", lambda v: abs(float(v))),
                (T.SPECTRUM_AVG, "fft_avg", lambda v: max(1, abs(int(v)))),
                (T.SPECTRUM_OVERLAP, "spectrum_overlap", float),
            ):
                if key in fields:
                    v = conv(fields[key])
                    if v != getattr(template, field) and (key is not T.SPECTRUM_OVERLAP or 0 <= v < 1):
                        repl[field] = v
            if T.WINDOW_TYPE in fields:
                from ..ops.windows import WINDOW_TYPES  # order == window.h enum

                wt = int(fields[T.WINDOW_TYPE])
                if 0 <= wt < len(WINDOW_TYPES) and WINDOW_TYPES[wt] != template.spectrum_window:
                    repl["spectrum_window"] = WINDOW_TYPES[wt]

        if T.KAISER_BETA in fields:
            b = abs(float(fields[T.KAISER_BETA]))
            if math.isfinite(b) and b != (ch.kaiser_beta or template.kaiser_beta):
                ch.kaiser_beta = b
                refilter = True
        if T.FILTER2_KAISER_BETA in fields:
            b = abs(float(fields[T.FILTER2_KAISER_BETA]))
            if math.isfinite(b):
                ch.filter2_beta = b
                refilter = True

        if repl or template is not spec0:
            if repl:
                template = dataclasses.replace(template, **repl)
            self._move_channel(ch, template, carry=carry, low=low, high=high)
            refilter = False  # move re-applies edges/betas
            eng = self.engine  # a move may have rebuilt the engine

        g, i = ch.group, ch.idx
        if T.RADIO_FREQUENCY in fields:
            self._retune(ch, abs(float(fields[T.RADIO_FREQUENCY])))
        new_low, new_high = fields.get(T.LOW_EDGE), fields.get(T.HIGH_EDGE)
        if new_low is not None or new_high is not None or refilter:
            lo = float(new_low) if new_low is not None else ch.low
            hi = float(new_high) if new_high is not None else ch.high
            lo = max(lo, -ch.samprate / 2)
            hi = min(hi, ch.samprate / 2)
            self.params = eng.set_edges(self.params, g, i, lo, hi,
                                        ch.kaiser_beta, ch.filter2_beta)
            ch.low, ch.high = min(lo, hi), max(lo, hi)

        spec = eng.groups[g].spec
        gp = eng.groups[g].host["demod"]

        def setp(key, value):
            self._setp_user(ch, key, value)

        if T.SQUELCH_OPEN in fields and "squelch_open" in gp:
            setp("squelch_open", np.float32(dB_to_power(float(fields[T.SQUELCH_OPEN]))))
        if T.SQUELCH_CLOSE in fields and "squelch_close" in gp:
            setp("squelch_close", np.float32(dB_to_power(float(fields[T.SQUELCH_CLOSE]))))
        if T.HEADROOM in fields and "headroom" in gp:
            setp("headroom", np.float32(dB_to_voltage(-abs(float(fields[T.HEADROOM])))))
        if T.GAIN in fields and "manual_gain" in gp:
            setp("manual_gain", np.float32(dB_to_voltage(float(fields[T.GAIN]))))
            # manual gain implies AGC off (radio_status.c:404)
            setp("agc_enable", False)
        if T.AGC_ENABLE in fields and "agc_enable" in gp:
            setp("agc_enable", bool(fields[T.AGC_ENABLE]))
        if T.AGC_HANGTIME in fields and "hangtime_samples" in gp:
            setp("hangtime_samples", np.int32(abs(float(fields[T.AGC_HANGTIME])) * ch.samprate))
        if T.AGC_RECOVERY_RATE in fields and "recovery_per_sample" in gp:
            setp("recovery_per_sample",
                 np.float32(dB_to_voltage(abs(float(fields[T.AGC_RECOVERY_RATE])) / ch.samprate)))
        if T.AGC_THRESHOLD in fields and "threshold" in gp:
            setp("threshold", np.float32(dB_to_voltage(-abs(float(fields[T.AGC_THRESHOLD])))))
        if T.PL_TONE in fields and "tone_freq" in gp:
            setp("tone_freq", np.float32(float(fields[T.PL_TONE])))
        if T.THRESH_EXTEND in fields and "threshold_ext" in gp:
            setp("threshold_ext", bool(fields[T.THRESH_EXTEND]))
        if T.PLL_BW in fields and "pll_loop_bw" in gp:
            setp("pll_loop_bw", np.float32(abs(float(fields[T.PLL_BW]))))
        if T.PLL_SQUARE in fields and "pll_square" in gp:
            setp("pll_square", bool(fields[T.PLL_SQUARE]))
        if T.SNR_SQUELCH in fields and "snr_squelch_enable" in gp:
            setp("snr_squelch_enable", bool(fields[T.SNR_SQUELCH]))
        if T.OUTPUT_CHANNELS in fields and spec.demod == "wfm" and "stereo_enable" in gp:
            # 2 channels enables FM stereo, 1 disables (radio_status.c:452-456)
            setp("stereo_enable", int(fields[T.OUTPUT_CHANNELS]) == 2)
        if T.SHIFT_FREQUENCY in fields and "shift_inc_q32" in gp:
            from ..ops.osc import rev_to_q32
            setp("shift_inc_q32", rev_to_q32(float(fields[T.SHIFT_FREQUENCY]) / ch.samprate))

        # ---- host-side keys ----
        if T.STATUS_INTERVAL in fields:
            ch.update_every = abs(int(fields[T.STATUS_INTERVAL]))
            self._beacon_plans.pop(ch.group, None)
        if T.SPECTRUM_BASE in fields:
            ch.spectrum_base = float(fields[T.SPECTRUM_BASE])
        if T.SPECTRUM_STEP in fields:
            ch.spectrum_step = float(fields[T.SPECTRUM_STEP])
        if T.OUTPUT_ENCODING in fields:
            self._set_encoding(ch, int(fields[T.OUTPUT_ENCODING]))
        opus_knobs = False
        if T.OPUS_BIT_RATE in fields:
            ch.opus_bitrate = abs(int(fields[T.OPUS_BIT_RATE]))
            ch.opus_encoder = None
            opus_knobs = True
        if T.OPUS_DTX in fields:
            ch.opus_dtx = bool(fields[T.OPUS_DTX])
            ch.opus_encoder = None
            opus_knobs = True
        if T.OPUS_APPLICATION in fields:
            app = int(fields[T.OPUS_APPLICATION])
            if app in (2048, 2049, 2051):  # VOIP/AUDIO/LOWDELAY
                ch.opus_app = app
                ch.opus_encoder = None  # requires an encoder restart
                opus_knobs = True
        if opus_knobs and ch.group in self.edges:
            self._refresh_edges()  # push the new knobs into the C++ encoder
        if T.MAXDELAY in fields:
            d = abs(int(fields[T.MAXDELAY]))
            if d <= 5 and d != ch.maxdelay:  # 0 overrides a [global] block=
                ch.maxdelay = d
                self._refresh_edges()  # aggregated channels leave the edge
        if T.OUTPUT_DATA_DEST_SOCKET in fields:
            self._set_dest(ch, fields[T.OUTPUT_DATA_DEST_SOCKET])
        if T.RF_GAIN in fields and hasattr(self.frontend, "set_gain"):
            self.frontend.set_gain(float(fields[T.RF_GAIN]))
        if T.RF_ATTEN in fields and hasattr(self.frontend, "set_atten"):
            self.frontend.set_atten(float(fields[T.RF_ATTEN]))
        if T.FIRST_LO_FREQUENCY in fields and hasattr(self.frontend, "set_lo"):
            self.frontend.set_lo(abs(float(fields[T.FIRST_LO_FREQUENCY])))
        if T.DOPPLER_FREQUENCY in fields or T.DOPPLER_FREQUENCY_RATE in fields:
            dop = self.doppler.setdefault(ch.ssrc, [0.0, 0.0])
            if T.DOPPLER_FREQUENCY in fields:
                dop[0] = float(fields[T.DOPPLER_FREQUENCY])
            if T.DOPPLER_FREQUENCY_RATE in fields:
                dop[1] = float(fields[T.DOPPLER_FREQUENCY_RATE])
            if dop == [0.0, 0.0]:
                del self.doppler[ch.ssrc]
                try:
                    self.params = self.engine.retune(self.params, ch.group, ch.idx, ch.freq)
                except ValueError:
                    pass
        if T.LIFETIME in fields:
            ch.lifetime = ch.lifetime_init = int(fields[T.LIFETIME])
            ch.dynamic = ch.dynamic or ch.lifetime > 0
            if ch.dynamic:
                self._dyn_ssrcs.add(ch.ssrc)
        if T.SETOPTS in fields:
            ch.options |= int(fields[T.SETOPTS])
        if T.CLEAROPTS in fields:
            ch.options &= ~int(fields[T.CLEAROPTS])

    # -------------------------------------------------------------- status
    def encode_channel_status(self, ch: _Chan, tag: int = 0) -> bytes:
        """encode_radio_status subset (radio_status.c:706-915)."""
        grp = self.engine.groups[ch.group]
        spec = grp.spec
        # the channel's own input: its IF power, first LO and gain chain
        # (one front end: the first, as before)
        i_in = int(grp.inputs[ch.idx])
        fe = self.frontends[i_in] if self.frontends else self.frontend
        # big-group channels skip the per-channel loop: their info comes
        # from the group's (lazily fetched) latest dispatch, and RTP
        # bookkeeping lives in the native edge's arrays
        info = ch.last_info or self._ginfo.get(ch.group) or {}
        if ch.group in self.edges:
            _edge = self.edges[ch.group][0]
            if ch.idx < _edge.C:
                ch.rtp_seq = int(_edge.seq[ch.idx])
                ch.rtp_timestamp = int(_edge.ts[ch.idx])
        g = lambda k, d=0.0: float(np.asarray(info[k][ch.idx])) if k in info else d
        fields: dict[T, Any] = {
            T.OUTPUT_SSRC: ch.ssrc,
            T.COMMAND_TAG: tag,
            T.GPS_TIME: _gps_time_ns(),
            T.DESCRIPTION: self.description,
            T.RTP_TIMESNAP: ch.rtp_timestamp,
            T.STATUS_INTERVAL: self.update_every,
            T.AD_BITS_PER_SAMPLE: 16,
            T.OUTPUT_SAMPLES: ch.rtp_timestamp,
            T.INPUT_SAMPLES: self.blocks * self.engine.L,
            T.CMD_CNT: ch.commands,
            T.RADIO_FREQUENCY: ch.freq,
            T.DEMOD_TYPE: DEMOD_TYPE_CODES.get(spec.demod, 0),
            T.LOW_EDGE: ch.low,
            T.HIGH_EDGE: ch.high,
            T.KAISER_BETA: ch.kaiser_beta if ch.kaiser_beta is not None else spec.kaiser_beta,
            T.OUTPUT_SAMPRATE: ch.samprate,
            T.OUTPUT_CHANNELS: ch.channels,
            T.INPUT_SAMPRATE: int(self.engine.samprate),
            T.FE_ISREAL: self.engine.master.real,
            T.FILTER_BLOCKSIZE: self.engine.master.L,
            T.FILTER_FIR_LENGTH: self.engine.master.M,
            T.RTP_PT: ch.pt,
            T.OUTPUT_ENCODING: int(ch.encoding),
            T.OUTPUT_DATA_PACKETS: ch.data_packets,
            T.OUTPUT_METADATA_PACKETS: ch.metadata_packets,
            T.FILTER_DROPS: self.block_drops,
            T.SETOPTS: ch.options,
            T.TP1: self.t_avg * 1e3,  # test points: block time ms / drops
            T.TP2: float(self.block_drops),
            T.IF_POWER: power_to_dB(max(
                float(self.if_power_in[i_in])
                if i_in < self.if_power_in.size else self.if_power, 1e-30)),
            T.BASEBAND_POWER: power_to_dB(max(g("baseband_power"), 1e-30)),
            T.NOISE_DENSITY: power_to_dB(max(g("n0"), 1e-30)),
            T.OUTPUT_LEVEL: power_to_dB(max(g("output_power"), 1e-30)),
            T.OUTPUT_ERRORS: self.output_errors,
            T.OUTPUT_TTL: (spec.ttl if spec.ttl is not None
                           else int(self.cfg.options.get("ttl", 1))),
            # front-end coverage edges, IF-relative like the reference's
            # min_IF/max_IF (the park/unpark bound, radio.c:1472), and the
            # front-end center (radio_status.c:746)
            T.FE_LOW_EDGE: 0.0 if self.engine.master.real else -self.engine.samprate / 2,
            T.FE_HIGH_EDGE: self.engine.samprate / 2,
            T.FIRST_LO_FREQUENCY: float(grp.center_of[ch.idx]),
            # frontend calibration/gain chain (zeros for synthetic/RTP FEs)
            T.CALIBRATE: float(getattr(fe, "calibrate", 0.0)),
            T.RF_LEVEL_CAL: float(getattr(fe, "rf_level_cal", 0.0)),
            T.RF_GAIN: float(getattr(fe, "rf_gain", 0.0)),
            T.LNA_GAIN: int(getattr(fe, "lna_gain", 0)),
            T.MIXER_GAIN: int(getattr(fe, "mixer_gain", 0)),
            T.IF_GAIN: int(getattr(fe, "if_gain", 0)),
            T.AD_OVER: int(getattr(fe, "ad_over", 0)),
            T.SAMPLES_SINCE_OVER: int(getattr(fe, "samples_since_over",
                                              self.blocks * self.engine.L)),
        }
        # the channel's second (fine-tune) LO: Q32 increment at the group
        # input rate (compute_tuning remainder, radio.c:1216-1241)
        inc = grp.host.get("inc_q32")
        if inc is not None:
            fields[T.SECOND_LO_FREQUENCY] = (
                float(np.int64(np.int32(np.uint32(inc[ch.idx]))) / 2**32 * grp.fs_in))
        # socket triplet: where data goes, where beacons go, and the ONE
        # source socket both leave (the session-matching key)
        if self.data_sock is not None:
            gdest, _ = self._group_data_dest(ch.group)
            fields[T.OUTPUT_DATA_DEST_SOCKET] = gdest
            fields[T.STATUS_DEST_SOCKET] = (gdest[0], DEFAULT_STAT_PORT)
            src = None
            if ch.group in self.edges:
                src = self._edge_src_addr(self.edges[ch.group][0])
            elif ch.dest_sock is None:
                try:
                    src = self.data_sock.getsockname()
                except OSError:
                    pass
            if src:
                fields[T.OUTPUT_DATA_SOURCE_SOCKET] = (src[0], src[1])
        if spec.demod in ("fm", "wfm"):
            fields[T.FM_SNR] = power_to_dB(max(g("fm_snr"), 1e-30))
            hd = self.engine.groups[ch.group].host["demod"]
            if "deemph_rate" in hd:
                # the host keeps the one-pole alpha: a = 1 - exp(-1/(fs*tc))
                a = float(hd["deemph_rate"][ch.idx])
                if 0.0 < a < 1.0:
                    fields[T.DEEMPH_TC] = -1e6 / (ch.samprate * np.log(1.0 - a))
            if "deemph_gain" in hd:
                fields[T.DEEMPH_GAIN] = voltage_to_dB(max(float(hd["deemph_gain"][ch.idx]), 1e-15))
            fields[T.PEAK_DEVIATION] = g("pdeviation")
            fields[T.FREQ_OFFSET] = g("foffset")
            if "tone_deviation" in info:
                fields[T.PL_DEVIATION] = g("tone_deviation")
                fields[T.PL_TONE] = float(hd["tone_freq"][ch.idx])
            fields[T.THRESH_EXTEND] = (bool(hd["threshold_ext"][ch.idx])
                                       if "threshold_ext" in hd else spec.threshold_extend)
        elif spec.demod == "spectrum":
            grp = self.engine.groups[ch.group]
            geo = grp.wide_geo if grp.spectrum_wide else grp.spectrum_geo
            fields[T.RESOLUTION_BW] = geo.rbw
            fields[T.BIN_COUNT] = spec.bin_count
            if getattr(geo, "noise_bw", None):
                fields[T.NOISE_BW] = geo.noise_bw
            fields[T.SPECTRUM_FFT_N] = geo.fft_n
            fields[T.SPECTRUM_AVG] = geo.fft_avg
            if "bin_data" in info and self._spectrum_bins_ready(ch):
                bins = np.asarray(info["bin_data"][ch.idx], np.float64)  # lowest-first
                if self.spectrum_rice:
                    from ..net.rice import quantize_bins, rice_encode

                    base = ch.spectrum_base if ch.spectrum_base is not None else self.spectrum_base
                    step = ch.spectrum_step if ch.spectrum_step is not None else self.spectrum_step
                    fields[T.SPECTRUM_BASE] = base
                    fields[T.SPECTRUM_STEP] = step
                    fields[T.BIN_RICE_DATA] = rice_encode(quantize_bins(bins, base, step))
                elif self.spectrum_byte:
                    # v2 byte format (encode_byte_data, spectrum.c:536-554):
                    # most-negative-first — our internal order already;
                    # base/step per channel (SPECTRUM_BASE/STEP commands)
                    base = ch.spectrum_base if ch.spectrum_base is not None else self.spectrum_base
                    step = ch.spectrum_step if ch.spectrum_step is not None else self.spectrum_step
                    db = 10.0 * np.log10(np.maximum(bins, 1e-30))
                    q = np.clip((db - base) / step, 0, 255)
                    fields[T.SPECTRUM_BASE] = base
                    fields[T.SPECTRUM_STEP] = step
                    fields[T.BIN_BYTE_DATA] = bytes(np.rint(q).astype(np.uint8))
                else:
                    # BIN_DATA goes out in FFT order like radiod (powers.c:
                    # "Note these are still in FFT order")
                    fields[T.BIN_DATA] = [float(x) for x in np.roll(bins, -(bins.size // 2))]
        else:
            if "snr" in info and np.isfinite(g("snr")):
                fields[T.PLL_SNR] = power_to_dB(max(g("snr"), 1e-30))
            hd = self.engine.groups[ch.group].host["demod"]
            fields[T.PLL_ENABLE] = spec.enable_pll
            fields[T.PLL_SQUARE] = (bool(hd["pll_square"][ch.idx])
                                    if "pll_square" in hd else spec.pll_square)
            if "pll_loop_bw" in hd:
                fields[T.PLL_BW] = float(hd["pll_loop_bw"][ch.idx])
            fields[T.ENVELOPE] = spec.envelope
            fields[T.AGC_ENABLE] = bool(self.engine.groups[ch.group].host["demod"]["agc_enable"][ch.idx])
            if "gain" in info:
                fields[T.GAIN] = voltage_to_dB(max(g("gain"), 1e-30))
            if spec.enable_pll:
                fields[T.PLL_LOCK] = bool(np.asarray(info["pll_lock"][ch.idx])) if "pll_lock" in info else False
                fields[T.FREQ_OFFSET] = g("foffset")
                if "cphase" in info:
                    fields[T.PLL_PHASE] = g("cphase")
                if "pll_wraps" in info:
                    fields[T.PLL_WRAPS] = int(np.asarray(info["pll_wraps"][ch.idx]))
        host_d0 = self.engine.groups[ch.group].host["demod"]
        fields[T.SNR_SQUELCH] = (bool(host_d0["snr_squelch_enable"][ch.idx])
                                 if "snr_squelch_enable" in host_d0 else spec.snr_squelch)
        if ch.preset:
            fields[T.PRESET] = ch.preset
        if spec.filter2:
            grp = self.engine.groups[ch.group]
            fields[T.FILTER2] = spec.filter2
            if grp.f2_N:
                fields[T.FILTER2_BLOCKSIZE] = grp.olen
                fields[T.FILTER2_FIR_LENGTH] = grp.f2_N - grp.olen + 1
            fields[T.FILTER2_KAISER_BETA] = (ch.filter2_beta if ch.filter2_beta is not None
                                             else spec.filter2_kaiser_beta or spec.kaiser_beta)
        if spec.isb:
            fields[T.INDEPENDENT_SIDEBAND] = True
        if ch.maxdelay is not None:
            fields[T.MAXDELAY] = ch.maxdelay
        if ch.encoding in (Encoding.OPUS, Encoding.OPUS_VOIP):
            fields[T.OPUS_BIT_RATE] = ch.opus_bitrate
            fields[T.OPUS_DTX] = ch.opus_dtx
            fields[T.OPUS_FEC] = False
            if ch.opus_encoder is not None:
                try:
                    fields[T.OPUS_BANDWIDTH] = ch.opus_encoder.bandwidth()
                except OSError:
                    pass
            if ch.opus_app:
                fields[T.OPUS_APPLICATION] = ch.opus_app
        host_d = self.engine.groups[ch.group].host["demod"]
        if "squelch_open" in host_d:
            fields[T.SQUELCH_OPEN] = power_to_dB(float(host_d["squelch_open"][ch.idx]))
            fields[T.SQUELCH_CLOSE] = power_to_dB(float(host_d["squelch_close"][ch.idx]))
        ch.metadata_packets += 1
        return encode_status(fields)

    # ---------------------------------------------------------------- data
    def _emit_rtp(self, ch: _Chan, audio: np.ndarray, send: bool):
        """Packetize one block of audio (audio.c:42-212). Marker bit set on
        the first packet after silence, timestamps advance even when muted."""
        nsamp = audio.shape[0]
        if ch.encoding in (Encoding.OPUS, Encoding.OPUS_VOIP):
            # Opus RTP timestamps tick at 48 kHz regardless of input rate
            ts_inc = nsamp * 48_000 // ch.samprate
            if not send:
                ch.rtp_timestamp = (ch.rtp_timestamp + ts_inc) & 0xFFFFFFFF
                ch.sending = False
                return
            if ch.opus_encoder is None:
                from .. net.opus import OpusEncoder, OPUS_APPLICATION_VOIP, OPUS_APPLICATION_AUDIO
                app = ch.opus_app if ch.opus_app else (
                    OPUS_APPLICATION_VOIP if ch.encoding == Encoding.OPUS_VOIP else OPUS_APPLICATION_AUDIO)
                ch.opus_encoder = OpusEncoder(ch.samprate, min(ch.channels, 2), app,
                                              bitrate=ch.opus_bitrate, dtx=ch.opus_dtx)
            payload = ch.opus_encoder.encode(audio)
            hdr = RtpHeader(type=ch.pt, seq=ch.rtp_seq, timestamp=ch.rtp_timestamp,
                            ssrc=ch.ssrc, marker=not ch.sending)
            self._send_data(hdr.pack() + payload, ch.dest_sock, ch.group)
            ch.rtp_seq = (ch.rtp_seq + 1) & 0xFFFF
            ch.rtp_timestamp = (ch.rtp_timestamp + ts_inc) & 0xFFFFFFFF
            ch.data_packets += 1
            ch.sending = True
            return
        if not send:
            ch.rtp_timestamp = (ch.rtp_timestamp + nsamp) & 0xFFFFFFFF
            ch.sending = False
            return
        payload = encode_samples(audio, ch.encoding)
        bytes_per_frame = max(len(payload) // nsamp, 1)
        max_frames = max(1400 // bytes_per_frame, 1)
        off = 0
        first = True
        while off < nsamp:
            n = min(max_frames, nsamp - off)
            hdr = RtpHeader(
                type=ch.pt, seq=ch.rtp_seq, timestamp=ch.rtp_timestamp, ssrc=ch.ssrc,
                marker=(first and not ch.sending),
            )
            self._send_data(hdr.pack() + payload[off * bytes_per_frame : (off + n) * bytes_per_frame],
                            ch.dest_sock, ch.group)
            ch.rtp_seq = (ch.rtp_seq + 1) & 0xFFFF
            ch.rtp_timestamp = (ch.rtp_timestamp + n) & 0xFFFFFFFF
            ch.data_packets += 1
            off += n
            first = False
        ch.sending = True

    # ---------------------------------------------------------------- main
    def _steer_doppler(self):
        """Advance doppler-steered channels (DOPPLER_FREQUENCY[_RATE]):
        per-block retune with the accumulated offset — pure params surgery,
        nothing rebuilt (satellite tracking, radio.h doppler fields)."""
        for ssrc, dop in list(self.doppler.items()):
            ch = self.chans.get(ssrc)
            if ch is None:
                del self.doppler[ssrc]
                continue
            dop[0] += dop[1] * self.cfg.blocktime
            base = ch.freq
            self._retune(ch, ch.freq + dop[0])
            ch.freq = base  # doppler offsets don't move the dial frequency

    def _send_sap(self):
        if getattr(self, "sap", None) is None:
            return
        enc_names = {Encoding.S16BE: "L16", Encoding.OPUS: "opus", Encoding.MULAW: "PCMU",
                     Encoding.ALAW: "PCMA", Encoding.F32LE: "F32LE", Encoding.F32BE: "F32BE",
                     Encoding.F16LE: "F16LE", Encoding.F16BE: "F16BE", Encoding.S16LE: "L16LE"}
        pts = []
        seen = set()
        group_pts: dict[str, set] = {}  # one pass; avoids O(C·groups)
        for ch in self.chans.values():
            group_pts.setdefault(ch.group, set()).add(ch.pt)
            if ch.pt in seen:
                continue
            seen.add(ch.pt)
            pts.append((ch.pt, enc_names.get(ch.encoding, ch.encoding.name),
                        48_000 if ch.encoding in (Encoding.OPUS, Encoding.OPUS_VOIP) else ch.samprate,
                        ch.channels))
        self.sap.announce(self.description, self._sap_dest[0], self._sap_dest[1],
                          pts, self._sap_ttl)
        # per-section `data =` streams get their own session announcements
        for gname, g in self.engine.groups.items():
            if not g.spec.data:
                continue
            gdest, _ = self._group_data_dest(gname)
            gpts = [(pt, e, r, c) for pt, e, r, c in pts
                    if pt in group_pts.get(gname, ())]
            if gpts:
                self.sap.announce(f"{self.description}/{gname}", gdest[0], gdest[1],
                                  gpts, self._sap_ttl)

    def _send_rtcp(self):
        if self.rtcp_sock is None:
            return
        from ..net.rtcp import build_sr, build_sdes, compound
        big_table = len(self.chans) >= self.big_group_c
        for ch in self.chans.values():
            if not ch.sending and (ch.data_packets == 0 or big_table):
                continue  # big tables: RTCP only for currently-open channels
            pkt = compound(
                build_sr(ch.ssrc, ch.rtp_timestamp, ch.data_packets, 0),
                build_sdes(ch.ssrc, f"{self.description} ssrc {ch.ssrc}"),
            )
            # RTCP rides each channel's own stream group on port+1
            # (radio.c:1244-1435 sends per channel to its dest socket)
            gdest, _ = self._group_data_dest(ch.group)
            try:
                self.rtcp_sock.sendto(pkt, (gdest[0], gdest[1] + 1))
            except OSError:
                pass

    # -------------------------------------------------------- checkpoint
    @staticmethod
    def _flat_state(tree, prefix: str = "") -> dict:
        """{"groups/hf/dc/n0": tensor, ...} of a state tree (host mirrors
        left out: they travel in the checkpoint's metadata)."""
        out = {}
        for k, v in tree.items():
            if k == "host" and not prefix:
                continue
            if isinstance(v, dict):
                out.update(Radiod._flat_state(v, f"{prefix}{k}/"))
            else:
                out[f"{prefix}{k}"] = v
        return out

    def save_checkpoint(self, path: str):
        """Snapshot ALL carried DSP state (filter tails, AGC gains, squelch
        counters, noise floors, phase words), the host mirrors and the RTP
        bookkeeping to one .npz. The reference has no signal-state
        persistence (SURVEY.md §5)."""
        import json

        arrs = {k: v.cpu().numpy() for k, v in self._flat_state(self.state).items()}
        for sfx, st in self._src_states():
            arrs[f"__src_phase{sfx}__"] = st["phase"].cpu().numpy()
            arrs[f"__src_tone{sfx}__"] = st["tone_phase"].cpu().numpy()
            arrs[f"__src_gen{sfx}__"] = st["gen"].get_state().numpy()
        meta = {
            "blocks": self.blocks,
            "host": self.state["host"],
            "chans": {str(ssrc): {"seq": ch.rtp_seq, "ts": ch.rtp_timestamp,
                                  "freq": ch.freq, "group": ch.group, "idx": ch.idx}
                      for ssrc, ch in self.chans.items()},
        }
        np.savez_compressed(path, __meta__=json.dumps(meta), **arrs)

    def _src_states(self) -> list:
        """[(key suffix, generator state)]: "" for the one sig_gen, "1", "2",
        ... after it for those of several inputs."""
        if self.source_state is None:
            return []
        sts = self.source_state if isinstance(self.source_state, list) else [self.source_state]
        return [(str(i) if i else "", st) for i, st in enumerate(sts)]

    def load_checkpoint(self, path: str) -> bool:
        """Restore a snapshot taken with the same configuration. Returns
        False (untouched state) on any structure mismatch."""
        import json

        try:
            z = np.load(path, allow_pickle=False)
        except OSError:
            return False
        flat = self._flat_state(self.state)
        for key, leaf in flat.items():
            if key not in z or z[key].shape != tuple(leaf.shape) \
                    or z[key].dtype != leaf.cpu().numpy().dtype:
                return False
        meta = json.loads(str(z["__meta__"]))
        host = meta.get("host")
        if host is None or set(host["groups"]) != set(self.state["host"]["groups"]):
            return False
        for key, leaf in flat.items():
            leaf.copy_(torch.from_numpy(z[key]))
        self.state["host"] = {"jobnum": int(host["jobnum"]),
                              "groups": {n: {k: int(v) for k, v in h.items()}
                                         for n, h in host["groups"].items()}}
        srcs = self._src_states()
        if srcs and all(f"__src_phase{sfx}__" in z for sfx, _ in srcs):
            restored = []
            for sfx, st in srcs:
                st["gen"].set_state(torch.from_numpy(z[f"__src_gen{sfx}__"]))
                restored.append({
                    "phase": torch.from_numpy(z[f"__src_phase{sfx}__"]).to(self.device),
                    "tone_phase": torch.from_numpy(z[f"__src_tone{sfx}__"]).to(self.device),
                    "gen": st["gen"],
                })
            self.source_state = restored if isinstance(self.source_state, list) else restored[0]
        self.blocks = int(meta.get("blocks", 0))
        for ssrc_s, m in meta.get("chans", {}).items():
            ch = self.chans.get(int(ssrc_s))
            if ch is not None and ch.group == m["group"] and ch.idx == m["idx"]:
                ch.rtp_seq, ch.rtp_timestamp = int(m["seq"]), int(m["ts"])
        return True

    def _beacon_due(self, ch: _Chan) -> bool:
        """Per-channel beacon cadence (STATUS_INTERVAL cmd; 0 = off)."""
        ue = ch.update_every if ch.update_every is not None else self.update_every
        return ue > 0 and (self.blocks % ue) == 0

    def _staggered_beacons(self, gname: str, group_chans: list) -> None:
        """Beacons for a BIG group: a rotating slice per block, at most
        beacon-budget encodes, so every channel still beacons while the
        host cost per block stays bounded — the reference's staggered
        all-channel-dump discipline (radio_status.c:59-67).

        Each channel keeps its own interval (its STATUS_INTERVAL, else the
        daemon's `update`; 0 sends none). The plan (beacon_plan) is fixed
        per group until a channel or its interval changes."""
        plan = self._beacon_plans.get(gname)
        if plan is None:
            by_ue: dict[int, list] = {}
            for ch in group_chans:
                ue = ch.update_every if ch.update_every is not None else self.update_every
                if ue > 0:
                    by_ue.setdefault(ue, []).append(ch)
            plan = self._beacon_plans[gname] = beacon_plan(sorted(by_ue.items()),
                                                              self.beacon_budget)
        for chans, per, period, stride, phase in plan:
            if self.blocks % stride != phase:
                continue
            k = (self.blocks // stride) % period
            for ch in chans[k * per : (k + 1) * per]:
                self._send_beacon(self.encode_channel_status(ch), ch)

    def _record_block_time(self, dt: float):
        self._t_ring[self._t_n % self._t_ring.size] = dt
        self._t_n += 1

    def latency_percentiles(self, qs=(50, 99)) -> "tuple[float, ...]":
        """Block wall-time percentiles in seconds over the recent ring."""
        n = min(self._t_n, self._t_ring.size)
        if n == 0:
            return tuple(0.0 for _ in qs)
        return tuple(float(np.percentile(self._t_ring[:n], q)) for q in qs)

    def stats_line(self) -> str:
        p50, p99 = self.latency_percentiles()
        return (f"{self.blocks} blocks, {self.block_drops} drops, "
                f"block time avg {self.t_avg*1e3:.2f} ms "
                f"min {0 if self.t_min == float('inf') else self.t_min*1e3:.2f} "
                f"p50 {p50*1e3:.2f} p99 {p99*1e3:.2f} "
                f"max {self.t_max*1e3:.2f}, if_power "
                f"{10*np.log10(max(self.if_power,1e-30)):.1f} dBFS")

    @staticmethod
    def _slice_out(host_out: dict, d: int) -> dict:
        """One block's view of a time-sharded [D, ...] output batch."""
        sub = {}
        for name, g in host_out.items():
            if name.startswith("_"):
                sub[name] = {k: v[d] for k, v in g.items()}
            elif isinstance(g["info"], _LazyGroupInfo):
                sub[name] = {"audio": g["audio"][d], "info": g["info"].view(d)}
            else:
                sub[name] = {"audio": g["audio"][d],
                             "info": {k: v[d] for k, v in g["info"].items()}}
        return sub

    # per-block control leaves big groups always fetch (the rest of the
    # info tree is fetched lazily, on beacon/poll demand)
    _MINI_LEAVES = ("send", "egress_idx", "egress_count")

    def _fetch_out(self, out) -> dict:
        """Device->host copy for one dispatch, one synchronisation: small
        groups move whole; big groups (C >= big-group) move their audio
        and the per-block control leaves, and wrap the rest of the info
        tree for a lazy fetch on demand. With egress compaction the bytes
        scale with OPEN channels, not C."""
        fetch, lazy = {}, {}
        for name, g in out.items():
            if name.startswith("_") or self.engine.groups[name].C < self.big_group_c:
                fetch[name] = g
                continue
            info = g["info"]
            fetch[name] = {"audio": g["audio"],
                           "info": {k: info[k] for k in self._MINI_LEAVES
                                    if k in info}}
            lazy[name] = info
        host = _host_copy(fetch, self.device)
        for name, dev in lazy.items():
            host[name]["info"] = _LazyGroupInfo(dev, dict(host[name]["info"]))
        return host

    # a cold start slower than this (construction, with the kernel and native
    # edge builds, to the first block's outputs on the host, cuFFT plans
    # included) appends a line to <wisdom>/fft.log, the analog of the
    # reference's missing-wisdom log (filter.c:95-101), which
    # `fft-gen-torch --wisdom DIR` (no config) reads to warm offline
    FFT_LOG_THRESHOLD = 5.0

    def _log_cold_start(self, dt: float):
        cache_dir = self.cfg.options.get("wisdom", DEFAULT_WISDOM)
        if dt < self.FFT_LOG_THRESHOLD or not cache_dir:
            return
        if str(cache_dir).lower() in ("n", "no", "off"):
            return
        try:
            os.makedirs(cache_dir, exist_ok=True)
            with open(os.path.join(cache_dir, "fft.log"), "a") as fh:
                fh.write(f"{time.strftime('%Y-%m-%dT%H:%M:%S')} {dt:.1f}s "
                         f"N={self.engine.master.N} "
                         f"config={self.cfg.source_path or '<inline>'}\n")
        except OSError:
            pass

    def _read_frontend(self, n: int) -> np.ndarray:
        """n consecutive blocks (n = 1: one [L] block, or [B, L] from the B
        feeders of several inputs) from the host front ends; a block that a
        reader could not fill counts as a drop. Its host time (the readers'
        read_block, then the stacking) adds to `frontend_host`."""
        fes, L = self.frontends or [self.frontend], self.engine.L
        before = [getattr(fe, "timeouts", 0) for fe in fes]
        t_start, read_s, blocks = time.perf_counter(), 0.0, []
        for _ in range(n):
            t = time.perf_counter()
            rows = [np.asarray(fe.read_block(L)) for fe in fes]
            read_s += time.perf_counter() - t
            blocks.append(np.stack(rows))
        gaps = max(getattr(fe, "timeouts", 0) - b for fe, b in zip(fes, before))
        self.block_drops += min(gaps, n)
        if self.frontends is None:
            blocks = [b[0] for b in blocks]
        out = blocks[0] if n == 1 else np.stack(blocks)
        fh = self.frontend_host
        fh["reads"] += 1
        fh["ring_read_s"] += read_s
        fh["stack_s"] += time.perf_counter() - t_start - read_s
        return out

    def _to_device(self, block) -> torch.Tensor:
        """A host block to the engine's device: pinned, then copied with
        non_blocking=True (the host time of each, and the bytes, add to
        `frontend_host`)."""
        if torch.is_tensor(block):
            return block.to(self.device)
        t = torch.from_numpy(np.ascontiguousarray(block))
        if self.device.type == "cuda":
            fh, t0 = self.frontend_host, time.perf_counter()
            t = t.pin_memory()
            t1 = time.perf_counter()
            t = t.to(self.device, non_blocking=True)
            fh["copies"] += 1
            fh["pin_s"] += t1 - t0
            fh["copy_s"] += time.perf_counter() - t1
            fh["h2d_bytes"] += t.numel() * t.element_size()
        return t

    def frontend_split(self) -> dict:
        """The front-end host path's ms a dispatch since `frontend_host` was
        last zeroed: the readers' read_block (for RTP, the ring read and the
        I/Q interleave), the stacking of the blocks, pin_memory, and the
        copy's enqueue (non_blocking: the copy itself runs on the card),
        with the bytes copied to the card a dispatch."""
        fh = self.frontend_host
        per = lambda k, n: fh[k] * 1e3 / n if n else None  # noqa: E731
        return {"reads": fh["reads"], "ring_read_ms": per("ring_read_s", fh["reads"]),
                "stack_ms": per("stack_s", fh["reads"]), "pin_ms": per("pin_s", fh["copies"]),
                "copy_ms": per("copy_s", fh["copies"]),
                "h2d_bytes": fh["h2d_bytes"] / fh["copies"] if fh["copies"] else None}

    def step_block(self, block=None):
        """Run one dispatch end to end: one 20 ms block, or D consecutive
        blocks when the engine is time-sharded ([global] time-shards).
        Any error of the engine or the device propagates."""
        _t0 = time.monotonic()
        self._finish_restock()  # swap in a completed background pool grow
        self.poll_commands()
        if self.doppler:
            self._steer_doppler()
        if self.rtcp_sock is not None and self.blocks % self.rtcp_every >= self.rtcp_every - (self._time_shards or 1):
            self._send_rtcp()
            self._send_sap()
        if block is None and self.frontend is None and self.source_state is None:
            raise RuntimeError("no front end configured and no block given")
        D = self._time_shards
        if block is None:
            if self.frontend is not None:
                block = self._read_frontend(D or 1)
            else:
                self.source_state, block = self._siggen(self.source_state)
        first = self.blocks == 0
        self.state, out = self.step(self.state, self.params, self._to_device(block))
        host_out = self._fetch_out(out)
        if first:
            self._log_cold_start(time.monotonic() - self._t_start)
        if D:
            ret = None
            for d in range(D):
                self.blocks += 1
                ret = self._finish_block(self._slice_out(host_out, d))
            _dt = time.monotonic() - _t0
            self.t_avg += 0.01 * (_dt / D - self.t_avg)
            self.t_min = min(self.t_min, _dt / D)
            self.t_max = max(self.t_max, _dt / D)
            self._record_block_time(_dt / D)
            return ret
        self.blocks += 1
        ret = self._finish_block(host_out)
        _dt = time.monotonic() - _t0
        self.t_avg += 0.01 * (_dt - self.t_avg)
        self.t_min = min(self.t_min, _dt)
        self.t_max = max(self.t_max, _dt)
        self._record_block_time(_dt)
        return ret

    def _finish_block(self, host_out):
        """Host-side emission for ONE block's outputs: RTP packetization,
        beacons, dynamic-channel lifetimes, front-end metrics."""
        beacon = True  # per-channel cadence checked in _beacon_due
        self._decay_spectrum()
        fe = host_out.pop("_frontend", None)
        if fe is not None:
            # EMA like frontend->if_power smoothing in the drivers
            p = np.asarray(fe["if_power"], np.float64)
            self.if_power_in += 0.1 * (p - self.if_power_in)
            self.if_power = float(self.if_power_in[0])
        # fast path: whole-group native packetization + one sendmmsg batch
        for gname, (edge, group_chans) in self.edges.items():
            gout = host_out[gname]
            ginfo = gout["info"]
            audio = np.asarray(gout["audio"])
            big = len(group_chans) >= self.big_group_c
            sends = (np.asarray(ginfo["send"]) if "send" in ginfo
                     else np.ones(len(group_chans), bool))
            prev = self._send_prev.get(gname)
            if prev is None or prev.shape != sends.shape:
                prev = np.array([c.sending for c in group_chans])
            markers = sends & ~prev
            if "egress_idx" in ginfo:
                # squelch-compacted egress (audio.c:42-110): audio holds
                # only the open channels' rows; idx maps row -> channel
                idx = np.asarray(ginfo["egress_idx"])
                count = int(np.asarray(ginfo["egress_count"]))
                if count > idx.size:
                    self.egress_overflows += 1
                    if self.egress_overflows in (1, 100) or self.egress_overflows % 10_000 == 0:
                        print(f"egress overflow #{self.egress_overflows}: "
                              f"{count} open channels > {idx.size} slots in "
                              f"[{gname}] — raise egress-slots",
                              file=sys.stderr, flush=True)
                edge.send_indexed(audio, idx, min(count, idx.size), markers)
            else:
                edge.send_block(audio, sends, markers)
            # per-channel bookkeeping only where state CHANGED (O(edges)
            # not O(C)); status encoding reads seq/ts straight off the
            # edge arrays
            for i in np.nonzero(sends != prev)[0]:
                group_chans[i].sending = bool(sends[i])
            self._send_prev[gname] = sends
            group_chans[0].data_packets = edge.packets  # group-total stat
            if big:
                self._ginfo[gname] = ginfo
                if beacon:
                    self._staggered_beacons(gname, group_chans)
        big_edges = {g for g, (_, gc) in self.edges.items() if len(gc) >= self.big_group_c}
        for ch in self.chans.values():
            if ch.group in big_edges:
                continue  # big edge groups: handled above, O(C) loop skipped
            gout = host_out[ch.group]
            info = gout["info"]
            ch.last_info = info
            if ch.group in self.edges:
                c_edge = self.edges[ch.group][0]
                ch.rtp_seq = int(c_edge.seq[ch.idx])
                ch.rtp_timestamp = int(c_edge.ts[ch.idx])
                if beacon and self._beacon_due(ch):
                    self._send_beacon(self.encode_channel_status(ch), ch)
                continue
            send = bool(np.asarray(info["send"][ch.idx])) if "send" in info else True
            if ch.rds:
                audio = np.asarray(info["rds_baseband"][ch.idx])
            elif "egress_idx" in info:
                # compacted group on the Python path: row lookup by
                # channel index (muted channels get a zero block so the
                # RTP timestamp still advances)
                idx = np.asarray(info["egress_idx"])
                count = min(int(np.asarray(info["egress_count"])), idx.size)
                pos = np.nonzero(idx[:count] == ch.idx)[0]
                a_all = np.asarray(gout["audio"])
                if pos.size:
                    audio = a_all[int(pos[0])]
                else:
                    send = False
                    audio = np.zeros(a_all.shape[1:], np.float32)
            else:
                audio = np.asarray(gout["audio"][ch.idx])
            if not ch.rds and "stereo" in info and audio.ndim == 2:
                # WFM mono fallback switches the wire format per block:
                # channel count follows pilot presence and the payload type
                # is re-derived (wfm.c:226-276). Both output columns carry
                # the de-emphasized mono in fallback; send one.
                nch_now = 2 if bool(np.asarray(info["stereo"][ch.idx])) else 1
                if nch_now != ch.channels:
                    if ch.agg:  # flush queued blocks under the OLD format
                        self._emit_rtp(ch, np.concatenate(ch.agg), send=True)
                        ch.agg = []
                    ch.channels = nch_now
                    ch.pt = self.registry.pt_from_info(ch.samprate, nch_now, ch.encoding)
                if nch_now == 1:
                    audio = audio[:, 0]
            if audio.size:
                agg_n = ch.maxdelay if ch.maxdelay is not None else self.agg_blocks
                if agg_n > 0 and not ch.rds:
                    # aggregation queue (audio.c:64-110, MAXDELAY cmd):
                    # coalesce blocks, flush when full or on squelch close
                    if send:
                        ch.agg.append(audio)
                    if ch.agg and (not send or len(ch.agg) >= agg_n):
                        self._emit_rtp(ch, np.concatenate(ch.agg), send=True)
                        ch.agg = []
                    if not send:
                        self._emit_rtp(ch, audio, send=False)  # advance ts
                else:
                    self._emit_rtp(ch, audio, send=send)
            if beacon and self._beacon_due(ch):
                self._send_beacon(self.encode_channel_status(ch), ch)
        # idle dynamic channels count down and self-destruct (radio.c:1465)
        # (scan only the dynamic set — the table may hold 100k+ statics)
        expired = []
        for ssrc in self._dyn_ssrcs:
            ch = self.chans.get(ssrc)
            if ch is not None and ch.dynamic and ch.lifetime > 0:
                ch.lifetime -= 1
                if ch.lifetime == 0:
                    expired.append(ssrc)
        for ssrc in expired:
            self.remove_channel(ssrc)
        if self._deferred_status:
            # spectrum polls held for their first armed block (spectrum.c's
            # response-after-FFT ordering) — answer the ones now ready
            still = []
            for ssrc, tag in self._deferred_status:
                ch = self.chans.get(ssrc)
                if ch is None:
                    continue
                if self._spectrum_bins_ready(ch):
                    self._send_status(self.encode_channel_status(ch, tag), ch)
                else:
                    still.append((ssrc, tag))
            self._deferred_status = still
        return host_out

    def run(self, nblocks: int | None = None, realtime: bool = False):
        t0 = time.monotonic()
        k = 0
        per = self._time_shards or 1  # blocks per dispatch
        while nblocks is None or k < nblocks:
            self.step_block()
            k += per
            if realtime:
                target = t0 + k * self.cfg.blocktime
                dt = target - time.monotonic()
                if dt > 0:
                    time.sleep(dt)
