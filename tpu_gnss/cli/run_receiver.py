"""Full-receiver CLI: capture file in, acquisition table + fixes out.

The offline analog of the reference's live ``gps`` binary (main.cpp):
acquisition, tracking, NAV/ephemeris decode, and PVT on a capture file,
with the channel dashboard standing in for the LCD/UserStat UI
(reference: c/user.cpp).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..config import ReceiverConfig
from ..io.stream import FileSource1Bit, IQFileSource
from ..receiver import Receiver
from ..utils import metrics


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="gps_receiver",
        description="full GPS receiver on a capture file")
    p.add_argument("filename",
                   help="capture file, or rtltcp://host:port for live "
                        "SDR ingest from an rtl_tcp server")
    p.add_argument("fc", type=float, nargs="?", default=4.092e6)
    p.add_argument("fs", type=float, nargs="?", default=5.456e6)
    p.add_argument("max_fo", type=float, nargs="?", default=5000.0)
    p.add_argument("--preset", default=None,
                   choices=["live", "nottingham", "synthetic", "rtlsdr",
                            "hackrf"],
                   help="use a named capture preset for fc/fs/max_fo "
                        "(overrides the positional values)")
    p.add_argument("--format", choices=["1bit", "iq8", "iqu8"],
                   default="1bit")
    p.add_argument("--link", choices=["int8", "int4", "int2", "float32"],
                   default="int8", metavar="MODE",
                   help="host->device uplink quantization for 8-bit IQ "
                        "formats (and rtltcp://): int8 = the capture's "
                        "own bytes, int4 = packed nibbles (2x less "
                        "traffic, <0.1 dB), int2 = classic GNSS 2-bit "
                        "sign/magnitude (4x less, ~0.55 dB).  1-bit "
                        "captures always use the packed-word uplink")
    p.add_argument("--duration", type=float, default=None,
                   help="seconds of capture to process")
    p.add_argument("--threshold", type=float, default=25.0)
    p.add_argument("--channels", type=int, default=12)
    p.add_argument("--fft-len", type=int, default=40000,
                   help="acquisition window length in samples")
    p.add_argument("--checkpoint", default=None,
                   help="write receiver state (npz) here at the end")
    p.add_argument("--iq-log", default=None, metavar="FILE.npz",
                   help="dump per-channel prompt I/Q + code-rate "
                        "histories (the FPGA RSSI/IQ-logging analog) and "
                        "print a constellation scatter of the strongest "
                        "channel")
    p.add_argument("--warm-start", default=None,
                   help="load ephemerides from a previous checkpoint; a "
                        "fix then needs one subframe (~7 s) instead of "
                        "three (~20 s).  With a stored almanac + last "
                        "fix, the cold search is also DIRECTED to the "
                        "predicted-visible PRNs")
    p.add_argument("--no-directed", action="store_true",
                   help="disable the almanac-directed search even when "
                        "the warm-start checkpoint could support it")
    p.add_argument("--tow", type=float, default=None, metavar="SEC",
                   help="override the GPS time-of-week used for the "
                        "almanac visibility prediction (default: the "
                        "checkpoint's fix TOW advanced by elapsed wall "
                        "time)")
    p.add_argument("--nmea-out", default=None, metavar="FILE.nmea",
                   help="write fixes as NMEA GGA/GSA/GSV/RMC/VTG/GST "
                        "sentences (feed to cli.nmea monitor/compare)")
    p.add_argument("--follow", action="store_true",
                   help="live mode: tail the capture file while it "
                        "GROWS (SDR pipe / writer process), emitting "
                        "fixes in-stream at the solve cadence; ends on "
                        "a <file>.done sidecar or --stall-timeout of "
                        "no growth")
    p.add_argument("--stall-timeout", type=float, default=5.0,
                   help="--follow: seconds without file growth before "
                        "the stream is declared stalled")
    p.add_argument("--max-lag", type=float, default=None, metavar="SEC",
                   help="--follow: skip ahead when the reader falls "
                        "more than SEC behind the writer frontier")
    p.add_argument("--max-history", type=float, default=None,
                   metavar="SEC",
                   help="bound per-channel history to SEC seconds "
                        "(defaults to 600 in --follow mode, unbounded "
                        "otherwise); transmit-time anchors survive "
                        "trimming")
    p.add_argument("--if-offset", default="auto", metavar="HZ|auto",
                   help="TX/RX oscillator offset of a replay capture "
                        "(Hz).  'auto' (default) estimates it from the "
                        "cold-start Doppler median when that is "
                        "implausibly large for sky motion (>10 kHz); "
                        "pass 0 to disable (reference replay workflow: "
                        "README.md §2.1e, max_fo=100000)")
    p.add_argument("--rtl-freq", type=float, default=1575.42e6,
                   metavar="HZ",
                   help="rtl_tcp tuner center frequency (rtltcp:// "
                        "sources; default GPS L1)")
    p.add_argument("--rtl-gain", type=float, default=None, metavar="DB",
                   help="rtl_tcp manual tuner gain in dB (default: AGC)")
    p.add_argument("--rtl-ppm", type=int, default=0,
                   help="rtl_tcp frequency correction, ppm")
    p.add_argument("--mesh-devices", type=int, default=None, metavar="N",
                   help="distributed mode: run acquisition "
                        "Doppler-sharded and the tracking bank "
                        "channel-sharded over the first N jax devices "
                        "(N must divide the channel count)")
    args = p.parse_args(argv)
    from ..utils.jaxcache import enable_persistent_cache
    enable_persistent_cache()

    import os
    is_net = args.filename.startswith("rtltcp://")
    if not is_net and not os.path.exists(args.filename) and not args.follow:
        # --follow waits for the writer to create the file instead
        print(f"error: capture file not found: {args.filename}",
              file=sys.stderr)
        return 2
    if args.preset:
        from ..config import PRESETS
        base = PRESETS[args.preset]
        args.fc, args.fs, args.max_fo = base.fc, base.fs, base.max_fo
    cfg = ReceiverConfig(fs=args.fs, fc=args.fc, max_fo=args.max_fo,
                         fft_len=args.fft_len,
                         snr_threshold=args.threshold,
                         num_chans=args.channels)
    iq_dtype = "int8" if args.format == "iq8" else "uint8"
    if is_net:
        # live SDR over the rtl_tcp protocol: rtltcp://host:port.
        # Fixes stream in-stream (as with --follow); tune the dongle's
        # crystal error away with --if-offset auto + a wide max_fo
        from urllib.parse import urlsplit

        from ..io.stream import RtlTcpSource
        u = urlsplit(args.filename)   # handles IPv6 [::1]:port too
        try:
            port = u.port             # raises on a non-numeric port
        except ValueError:
            port = None
        if port is None:
            print(f"error: {args.filename}: rtltcp URL needs host:port "
                  "(e.g. rtltcp://127.0.0.1:1234)", file=sys.stderr)
            return 2
        if args.max_lag is not None:
            print("warning: --max-lag has no effect on rtltcp:// "
                  "sources (TCP backpressure is the flow control); "
                  "a receiver slower than fs will eventually overflow "
                  "the server's ring buffer", file=sys.stderr)
        try:
            src = RtlTcpSource(u.hostname or "127.0.0.1", port,
                               args.fs, freq_hz=args.rtl_freq,
                               gain_db=args.rtl_gain, ppm=args.rtl_ppm,
                               stall_timeout_s=args.stall_timeout)
        except (OSError, ValueError) as e:
            print(f"error: rtl_tcp connect failed: {e}", file=sys.stderr)
            return 2
        print(f"rtl_tcp: connected to {u.netloc} (tuner type "
              f"{src.tuner_type}, {src.tuner_gain_count} gain steps), "
              f"fs={args.fs:g}, freq={args.rtl_freq:g}")
        args.follow = True   # in-stream solving + live fix printing
    elif args.follow:
        from ..io.stream import FollowSource1Bit, FollowIQSource
        if args.format == "1bit":
            src = FollowSource1Bit(args.filename, cfg,
                                   stall_timeout_s=args.stall_timeout,
                                   max_lag_s=args.max_lag)
        else:
            src = FollowIQSource(args.filename, args.fs, dtype=iq_dtype,
                                 stall_timeout_s=args.stall_timeout,
                                 max_lag_s=args.max_lag)
    elif args.format == "1bit":
        src = FileSource1Bit(args.filename, cfg)
    else:
        src = IQFileSource(args.filename, args.fs, dtype=iq_dtype)

    warm = None
    search_prns = None
    if args.warm_start:
        from ..utils.checkpoint import load_state
        state = load_state(args.warm_start)
        warm = state.get("ephemerides")
        print(f"warm start: ephemerides for PRNs {sorted(warm or {})}")
        # almanac-directed cold search: a stored almanac plus the last
        # fix predicts which PRNs are above the horizon now, so the
        # sweep covers the visible subset instead of all 32 (with
        # in-receiver fallback to the full sweep if it under-delivers)
        alms = state.get("almanac")
        last = (state.get("meta") or {}).get("last_fix")
        if not args.no_directed and alms and last:
            import time as _time

            from ..nav.almanac import visible_prns
            # the stored TOW is the PREVIOUS session's time: predict at
            # the checkpoint time + elapsed wall clock, not at a time
            # hours in the past (sky geometry shifts ~0.5 deg/min).
            # Checkpoints without a wall timestamp can't be aged —
            # prediction still runs at the stored TOW (margin_s covers
            # a short restart) but says so.
            tow = float(last["tow"])
            wall = last.get("wall")
            if args.tow is not None:
                tow = float(args.tow)
            elif wall is not None:
                age = max(0.0, _time.time() - float(wall))
                tow = (tow + age) % 604800.0
                if age > 60.0:
                    print(f"warm start: advancing visibility time by "
                          f"{age/60.0:.1f} min since checkpoint")
            pred = visible_prns(alms, last["ecef"], tow,
                                mask_deg=5.0, margin_s=1800.0)
            # only a non-empty PROPER subset actually directs the sweep
            # (process_source discards anything else) — say which it is
            if pred and set(pred) < set(cfg.prns):
                search_prns = pred
                print(f"directed search: almanac predicts PRNs {pred} "
                      f"visible ({len(alms)} almanac entries)")
            else:
                why = ("no PRNs predicted visible (stale fix/time?)"
                       if not pred else "all PRNs predicted visible")
                print(f"almanac present but {why}; running the full "
                      f"{len(cfg.prns)}-PRN sweep")

    max_hist = args.max_history
    if max_hist is None and args.follow:
        max_hist = 600.0       # a live receiver must not grow unboundedly
    mesh = None
    if args.mesh_devices:
        from ..dist.shard import make_mesh
        mesh = make_mesh(args.mesh_devices, axes=("dop",))
    if_off = (args.if_offset if args.if_offset == "auto"
              else float(args.if_offset))
    recv = Receiver(cfg, max_history_s=max_hist, mesh=mesh,
                    if_offset_hz=if_off, transfer_dtype=args.link)
    on_sol = None
    if args.follow:
        from . import nmea_out as _nm
        _live_nmea = open(args.nmea_out, "w") if args.nmea_out else None

        def on_sol(s):
            print(f"[fix t={s.snap_epoch/1000:7.1f}s] "
                  + metrics.solution_line(s), flush=True)
            if _live_nmea is not None:
                # stream each burst as the fix lands so an operator can
                # `tail -f | cli.nmea - --live`; the end-of-run
                # write_track below rewrites the file complete (with
                # the decoded GPS week)
                for ln in _nm.solution_burst(s, week=None):
                    _live_nmea.write(ln + "\r\n")
                _live_nmea.flush()
    with metrics.METRICS.stage("receiver.total"):
        result = recv.process_source(src, max_duration_s=args.duration,
                                     warm_ephemerides=warm,
                                     search_prns=search_prns,
                                     on_solution=on_sol)
    if args.follow:
        if _live_nmea is not None:
            _live_nmea.close()
        err = getattr(src, "error", None)
        why = ("stalled (no growth)" if getattr(src, "stalled", False)
               else f"connection error ({err})" if err
               else "end of stream")
        skipped = getattr(getattr(src, "reader", None),
                          "skipped_bytes", 0)
        print(f"\nfollow ended: {why}; "
              f"worst lag {getattr(src, 'max_lag_s', 0.0):.2f}s"
              + (f", skipped {skipped} bytes" if skipped else ""))

    print(f"\nacquired {len(result.detections)} SVs:")
    for d in result.detections:
        print(f"  PRN {d['prn']:2d}  snr {d['snr']:7.1f}  "
              f"dopp {d['doppler_hz']:+8.1f} Hz  ca {d['ca_shift']:7.1f}")

    live = [r for r in result.channels if not r.lost]
    if live:
        prns = [r.prn for r in live]
        pows = [float(np.mean(np.square(np.asarray(r.ip_hist[-50:]))))
                if len(r.ip_hist) else 0.0 for r in live]
        stat = []
        for r in live:
            base = ("eph" if r.eph.valid() else
                    (f"sf{len(r.subframes)}" if r.subframes else "track"))
            if r.cn0_dbhz and r.cn0_dbhz == r.cn0_dbhz:
                base += f" {r.cn0_dbhz:.0f}dBHz"
            stat.append(base)
        print("\n" + metrics.channel_bars(prns, pows, statuses=stat))

    if result.solutions:
        print("\nfixes (n_sats, iters, t_bias, lat, lon, alt):")
        for s in result.solutions:
            print("  " + metrics.solution_line(s))
        # the reference LCD's DMS + day/time pages (c/user.cpp:160-201)
        last = result.solutions[-1]
        print("  " + metrics.latlon_dms(last.lat_deg, last.lon_deg))
        week = next((r.eph.week for r in result.channels
                     if r.eph.valid()), None)
        if week is not None:
            print("  " + metrics.gps_day_time(int(week), last.t_rx))
    else:
        print("\nno position fix (need >=4 decoded ephemerides; capture "
              "must span >=3 subframes / ~18 s of NAV data)")

    if args.iq_log:
        tracked = [r for r in result.channels if len(r.ip_hist)]
        if tracked:
            metrics.save_iq_log(args.iq_log, tracked)
            best = max(tracked, key=lambda r: float(
                np.mean(np.square(np.asarray(r.ip_hist[-200:])))))
            # skip the pull-in transient when there is history beyond it
            skip = 200 if len(best.ip_hist) > 400 else 0
            print(f"\nIQ log ({len(tracked)} channels) -> {args.iq_log}; "
                  f"PRN {best.prn} prompt constellation:")
            print(metrics.iq_scatter_ascii(best.ip_hist[skip:],
                                           best.qp_hist[skip:]))

    if args.nmea_out:
        from . import nmea_out
        week = next((int(r.eph.week) for r in result.channels
                     if r.eph.valid()), None)
        n = nmea_out.write_track(args.nmea_out, result.solutions, week=week)
        print(f"\n{n} NMEA sentences -> {args.nmea_out}")

    if args.checkpoint:
        from ..utils.checkpoint import save_state
        import time as _time
        meta = dict(fs=cfg.fs, fc=cfg.fc, file=args.filename)
        if result.solutions:
            s = result.solutions[-1]
            # wall timestamp lets the next session age the TOW before
            # predicting visibility (a restart hours later must not
            # sweep yesterday's sky)
            meta["last_fix"] = dict(ecef=[s.x, s.y, s.z],
                                    tow=float(s.t_rx),
                                    wall=_time.time())
        save_state(args.checkpoint,
                   ephemerides={r.prn: r.eph for r in result.channels
                                if r.eph.valid()},
                   detections=result.detections,
                   almanac=recv.almanac,
                   meta=meta)
        print(f"\nstate saved to {args.checkpoint}"
              + (f" ({len(recv.almanac)} almanac entries)"
                 if recv.almanac else ""))

    print("\n" + metrics.METRICS.report())
    return 0


if __name__ == "__main__":
    sys.exit(main())
