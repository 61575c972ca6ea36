"""radiod-torch — the port's daemon CLI (reference main.c), on CUDA unless
--device says otherwise.

    radiod-torch [-v] [--blocks N] [--flat-out] [--device cpu] config.conf
"""
from __future__ import annotations

import argparse
import os
import sys
import time


def _parse_restart(v) -> float | None:
    """`restart =` global key: no/yes/<seconds>. None = don't restart."""
    s = str(v).strip().lower()
    if s in ("", "no", "n", "false", "off", "never"):
        return None
    if s in ("yes", "y", "true", "on", "always"):
        return 10.0
    return max(0.0, float(s))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="radiod-torch",
                                 description="multichannel SDR daemon on an NVIDIA GPU (PyTorch/CUDA)")
    ap.add_argument("config")
    ap.add_argument("-v", "--verbose", action="count", default=0)
    ap.add_argument("--blocks", type=int, default=None, help="exit after N blocks (default: run forever)")
    ap.add_argument("--flat-out", action="store_true", help="don't pace to wall clock (benchmarking)")
    ap.add_argument("--no-network", action="store_true", help="don't open sockets (dry run)")
    ap.add_argument("--checkpoint", default=None, help="state snapshot file (resume + periodic save)")
    ap.add_argument("--checkpoint-interval", type=float, default=60.0)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: cuda; 'cpu' runs the plain PyTorch path)")
    args = ap.parse_args(argv)

    # runtime-adjustable verbosity (main.c:204-212): SIGUSR1 raises,
    # SIGUSR2 lowers — lets an operator turn on the 10 s stats stream of
    # a running daemon without restarting it. Installed before the (slow)
    # engine build so an early signal can't kill the process.
    import signal as _signal

    class _Verb:
        level = args.verbose
    _signal.signal(_signal.SIGUSR1, lambda *_: setattr(_Verb, "level", _Verb.level + 1))
    _signal.signal(_signal.SIGUSR2, lambda *_: setattr(_Verb, "level", max(0, _Verb.level - 1)))

    from ..config import load_config
    from ..runtime.radiod import Radiod

    cfg = load_config(args.config)
    for w in cfg.warnings:
        print(f"config: {w}", file=sys.stderr)

    # `restart = yes|<sec>`: on a fatal failure, re-exec a FRESH
    # interpreter — the analog of the reference's systemd `Restart=always`
    # units (service/radiod@.service). Only armed for real CLI invocations
    # (argv is None) — programmatic main(argv) callers get the exception.
    restart_sec = _parse_restart(cfg.options.get("restart", "no"))

    def _fatal(e: BaseException):
        if restart_sec is None or argv is not None:
            raise e
        n = int(os.environ.get("KA9Q_RESTART_COUNT", "0")) + 1
        print(f"radiod-torch: fatal: {type(e).__name__}: "
              f"{str(e).splitlines()[0][:200] if str(e) else ''} — "
              f"restart #{n} in {restart_sec:.0f}s",
              file=sys.stderr, flush=True)
        time.sleep(restart_sec)
        os.environ["KA9Q_RESTART_COUNT"] = str(n)
        # module invocation is invariant to how generation 0 was launched
        # (console script, python -m, -c wrapper); execv keeps our environ
        os.execv(sys.executable,
                 [sys.executable, "-m", "ka9q_radio_tpu_torch.cli.radiod"] + sys.argv[1:])

    try:
        rd = Radiod(cfg, use_network=not args.no_network, device=args.device)
    except KeyboardInterrupt:
        return 0
    except Exception as e:
        _fatal(e)
        raise
    # unconditional banner (main.c prints version/config on startup);
    # also the cue that the SIGUSR1/2 verbosity handlers are armed
    print(f"radiod-torch: {len(rd.chans)} channels ready on {rd.device}", file=sys.stderr,
          flush=True)
    if args.checkpoint:
        if os.path.exists(args.checkpoint) and rd.load_checkpoint(args.checkpoint):
            print(f"resumed from {args.checkpoint} at block {rd.blocks}", file=sys.stderr)
    if _Verb.level:
        print(f"master: L={rd.engine.L} N={rd.engine.master.N} "
              f"fs={rd.engine.samprate:.0f} {'real' if rd.engine.master.real else 'complex'}",
              file=sys.stderr)
        for ssrc, ch in rd.chans.items():
            print(f"  ssrc {ssrc}: {ch.group}[{ch.idx}] {ch.freq:.0f} Hz "
                  f"{ch.samprate} Hz out pt={ch.pt}", file=sys.stderr)
    t0 = time.monotonic()
    try:
        remaining = args.blocks
        last_ckpt = time.monotonic()
        # a stats line every 500 blocks, at the end of a finite run, and at
        # the end of the first chunk (about 50 blocks, whole dispatches)
        # after SIGUSR1 raises the level
        per = rd._time_shards or 1
        chunk = -(-50 // per) * per
        since, shown = 0, _Verb.level
        while remaining is None or remaining > 0:
            n = chunk if remaining is None else min(chunk, remaining)
            rd.run(nblocks=n, realtime=not args.flat_out)
            since += n
            if remaining is not None:
                remaining -= n
            if _Verb.level and (since >= 500 or remaining == 0 or _Verb.level > shown):
                print(rd.stats_line(), file=sys.stderr)
                since = 0
            shown = _Verb.level
            if args.checkpoint and time.monotonic() - last_ckpt >= args.checkpoint_interval:
                rd.save_checkpoint(args.checkpoint)
                last_ckpt = time.monotonic()
    except KeyboardInterrupt:
        pass
    except Exception as e:
        _fatal(e)
        raise
    if _Verb.level:
        dt = time.monotonic() - t0
        print(f"{rd.blocks} blocks in {dt:.2f}s "
              f"({rd.blocks * rd.engine.L / max(dt, 1e-9) / 1e6:.1f} Msps)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
