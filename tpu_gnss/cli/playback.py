"""RF replay tooling: playback plans and the software replay loop.

The reference replays generated/captured GPS signals over the air with a
HackRF, driven by GNU Radio flowgraphs (``gps.grc``,
``gps_Nottingham.grc`` — file_source(int8 I/Q, repeat) → osmosdr sink at
1575.42 MHz, RF/IF/BB gains 10/20/20, 2 MHz bandwidth) or by
``hackrf_transfer`` (hackrf_transfer_script.txt), then re-receives the
signal with an rtl-sdr or a commercial NMEA receiver
(reference: README.md §2, SURVEY §2.3/§3.5).

Two equivalents here:

* ``plan``  — emit the exact transmitter invocation (hackrf_transfer
  command line and the flowgraph's sink parameters) for one of our
  generated TX files, so a user with the same hardware can replay it.
* ``loopback`` — run the whole replay loop in software: int8 I/Q TX file
  → RF channel model (oscillator offset / delay / gain / noise,
  tpu_gnss.signal.rfchannel) → optional rate conversion to the RX
  sample rate → 1-bit hard-limited IF capture, i.e. exactly the file
  ``gps_test`` consumes — optionally followed by acquisition on the
  result.  This is the reference's generate → transmit → capture →
  re-receive cycle (README.md §2.2) without radios, including the large
  frequency offsets that force its ``max_fo=100000`` searches.
"""

from __future__ import annotations

import argparse
import sys
from fractions import Fraction

import numpy as np


# transmitter profiles, matching the reference's flowgraphs / script
PROFILES = {
    # gps.grc: synthetic PRN-8 file at 8.184 Msps
    "synthetic": dict(fs=8.184e6, freq=1575.42e6),
    # gps_Nottingham.grc: converted Nottingham capture at 5.456 Msps
    "nottingham": dict(fs=5.456e6, freq=1575.42e6),
    # hackrf_transfer_script.txt: HDSDR wav capture at 2.8 Msps, tuned
    # 620 kHz low
    "wav": dict(fs=2.8e6, freq=1574.8e6),
    # adsb/adsb_out.grc: the repo's ADS-B side experiment (same TX chain,
    # different band) — kept for flowgraph parity
    "adsb": dict(fs=2e6, freq=1176.45e6),
}


def plan(args) -> int:
    prof = dict(PROFILES[args.profile])
    fs = args.fs or prof["fs"]
    freq = args.freq or prof["freq"]
    print(f"# transmit plan for {args.tx_file} (profile: {args.profile})")
    print(f"hackrf_transfer -s {int(fs)} -f {int(freq)} -t {args.tx_file}")
    print("# GNU Radio / osmosdr sink equivalent (gps.grc parameters):")
    print(f"#   sample_rate = {fs:g}")
    print(f"#   center_freq = {freq:g}")
    print("#   rf_gain = 10, if_gain = 20, bb_gain = 20, bandwidth = 2e6")
    print("#   source: interleaved int8 I/Q, repeat = True")
    if args.grc:
        with open(args.grc, "w") as f:
            f.write(emit_grc(args.tx_file, fs, freq))
        print(f"# flowgraph written: {args.grc} (GRC 3.8+ YAML; open in "
              "gnuradio-companion or run via grcc)")
    return 0


def emit_grc(tx_file: str, fs: float, freq: float) -> str:
    """Emit a GNU Radio Companion 3.8+ flowgraph for the TX chain.

    Reproduces the reference's replay chain (gps.grc: file_source(int8,
    repeat) -> deinterleave -> 2x char_to_float -> float_to_complex ->
    osmosdr/HackRF sink; SURVEY §2.3) as a freshly-generated modern YAML
    flowgraph — parameters match the reference's published sink settings.
    """
    def block(name, bid, params, coord):
        ps = "\n".join(f"    {k}: '{v}'" for k, v in params.items())
        return (f"- name: {name}\n  id: {bid}\n  parameters:\n{ps}\n"
                "  states:\n    bus_sink: false\n    bus_source: false\n"
                f"    bus_structure: null\n    coordinate: [{coord}, 100]\n"
                "    rotation: 0\n    state: enabled\n")

    blocks = [
        block("samp_rate", "variable", dict(value=int(fs)), 8),
        block("src", "blocks_file_source",
              dict(file=tx_file, type="byte", repeat="True", vlen=1,
                   begin_tag="pmt.PMT_NIL", offset=0, length=0), 200),
        block("deint", "blocks_deinterleave",
              dict(type="byte", num_streams=2, blocksize=1), 400),
        block("c2f_i", "blocks_char_to_float",
              dict(scale=1, vlen=1), 600),
        block("c2f_q", "blocks_char_to_float",
              dict(scale=1, vlen=1), 600),
        block("f2c", "blocks_float_to_complex", dict(vlen=1), 800),
        block("sink", "osmosdr_sink",
              dict(args='"hackrf=0"', sample_rate="samp_rate",
                   center_freq0=int(freq), freq_corr0=0, gain0=10,
                   if_gain0=20, bb_gain0=20, bw0="2e6", num_mboards=1,
                   num_channels=1, sync="sync", clock_source0="''",
                   time_source0="''", ant0="''"), 1000),
    ]
    conns = [
        "- [src, '0', deint, '0']",
        "- [deint, '0', c2f_i, '0']",
        "- [deint, '1', c2f_q, '0']",
        "- [c2f_i, '0', f2c, '0']",
        "- [c2f_q, '0', f2c, '1']",
        "- [f2c, '0', sink, '0']",
    ]
    return (
        "options:\n  parameters:\n    author: tpu_gnss\n"
        "    category: '[GRC Hier Blocks]'\n    cmake_opt: ''\n"
        "    comment: GPS replay TX (reference gps.grc equivalent)\n"
        "    copyright: ''\n    description: ''\n"
        "    gen_cmake: 'On'\n    gen_linking: dynamic\n"
        "    generate_options: no_gui\n    hier_block_src_path: '.:'\n"
        "    id: gps_replay_tx\n    max_nouts: '0'\n"
        "    output_language: python\n    placement: (0,0)\n"
        "    qt_qss_theme: ''\n    realtime_scheduling: ''\n"
        "    run: 'True'\n    run_command: '{python} -u {filename}'\n"
        "    run_options: run\n    sizing_mode: fixed\n"
        "    thread_safe_setters: ''\n    title: GPS replay\n"
        "    window_size: ''\n  states:\n    bus_sink: false\n"
        "    bus_source: false\n    bus_structure: null\n"
        "    coordinate: [8, 8]\n    rotation: 0\n    state: enabled\n\n"
        "blocks:\n" + "".join(blocks) + "\nconnections:\n"
        + "\n".join(conns) + "\n\nmetadata:\n  file_format: 1\n")


def loopback(args) -> int:
    from ..io import loaders
    from ..signal import rfchannel
    from ..signal.resample import resample_rational

    iq = loaders.load_int8_iq(args.tx_file, remove_dc=False)
    if args.duration is not None:
        iq = iq[: int(args.duration * args.fs_tx)]
    iq = rfchannel.apply_channel(
        iq, args.fs_tx, freq_offset_hz=args.freq_offset,
        delay_samples=args.delay, gain=args.gain,
        noise_std=args.noise, seed=args.seed)
    fs_rx = args.fs_rx or args.fs_tx
    if fs_rx != args.fs_tx:
        r = Fraction(fs_rx / args.fs_tx).limit_denominator(4096)
        iq = resample_rational(iq, r.numerator, r.denominator)
        fs_rx = args.fs_tx * r.numerator / r.denominator
    bits = loaders.iq_to_real_1bit(iq, args.fc_rx, fs_rx)
    with open(args.out_file, "wb") as f:
        f.write(loaders.pack_1bit(bits))
    print(f"loopback: wrote {len(bits)} samples ({len(bits) / fs_rx:.3f} s) "
          f"at fs={fs_rx:g}, IF={args.fc_rx:g}, "
          f"offset={args.freq_offset:g} Hz -> {args.out_file}")

    if args.acquire:
        from ..config import ReceiverConfig
        from ..acquire.search import Searcher
        cfg = ReceiverConfig(fs=fs_rx, fc=args.fc_rx, max_fo=args.max_fo)
        if len(bits) < cfg.fft_len:
            print(f"capture too short to acquire ({len(bits)} < "
                  f"{cfg.fft_len} samples)", file=sys.stderr)
            return 1
        s = Searcher(cfg)
        dets = s.detections(s.acquire_bits(bits[: cfg.fft_len]))
        print(f"{'PRN':>4} {'SNR':>8} {'lo_shift':>9} {'ca_shift':>9} "
              f"{'doppler_hz':>11}")
        for d in sorted(dets, key=lambda d: -d["snr"]):
            print(f"{d['prn']:>4} {d['snr']:>8.1f} {d['lo_shift']:>9} "
                  f"{d['ca_shift']:>9} {d['doppler_hz']:>11.1f}")
        if not dets:
            print("(no detections)")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpu_gnss.cli.playback", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    pp = sub.add_parser("plan", help="print the transmitter invocation")
    pp.add_argument("tx_file")
    pp.add_argument("--profile", choices=sorted(PROFILES), default="synthetic")
    pp.add_argument("--fs", type=float, help="override TX sample rate")
    pp.add_argument("--freq", type=float, help="override RF center freq")
    pp.add_argument("--grc", metavar="OUT.grc", default=None,
                    help="also write a GNU Radio Companion 3.8+ "
                         "flowgraph reproducing the reference TX chain")
    pp.set_defaults(fn=plan)

    lp = sub.add_parser("loopback",
                        help="software replay loop: int8 I/Q TX file -> "
                             "impaired 1-bit IF capture")
    lp.add_argument("tx_file", help="interleaved int8 I/Q (the .grc source)")
    lp.add_argument("out_file", help="output 1-bit IF capture")
    lp.add_argument("--fs-tx", type=float, default=8.184e6)
    lp.add_argument("--fs-rx", type=float, default=None,
                    help="RX sample rate (rational resample if != fs-tx)")
    lp.add_argument("--fc-rx", type=float, default=2.046e6,
                    help="RX IF the capture is mixed up to")
    lp.add_argument("--freq-offset", type=float, default=0.0,
                    help="TX/RX oscillator offset in Hz")
    lp.add_argument("--delay", type=float, default=0.0,
                    help="propagation delay in TX samples (fractional ok)")
    lp.add_argument("--gain", type=float, default=1.0)
    lp.add_argument("--noise", type=float, default=0.0,
                    help="AWGN std-dev per rail (TX amplitude units)")
    lp.add_argument("--seed", type=int, default=0)
    lp.add_argument("--duration", type=float, default=None,
                    help="seconds of the TX file to replay")
    lp.add_argument("--acquire", action="store_true",
                    help="run acquisition on the produced capture")
    lp.add_argument("--max-fo", type=float, default=100000.0,
                    help="Doppler search range when acquiring (the "
                         "reference uses 100 kHz for replayed captures)")
    lp.set_defaults(fn=loopback)

    ag = sub.add_parser(
        "adsb-gen",
        help="generate an adsb_for_hackrf.bin-style Mode S waveform "
             "(the reference's ADS-B side experiment plays a pre-made "
             "one; adsb/adsb_out.grc)")
    ag.add_argument("out_file", help="interleaved int8 I/Q output")
    ag.add_argument("--icao", type=lambda s: int(s, 16), default=0xABCDEF,
                    help="24-bit ICAO address, hex")
    ag.add_argument("--callsign", default="GNSSRX1")
    ag.add_argument("--lat", type=float, default=52.2572)
    ag.add_argument("--lon", type=float, default=3.9194)
    ag.add_argument("--alt-ft", type=float, default=38000.0)
    ag.add_argument("--repeat", type=int, default=1,
                    help="how many times to repeat the frame group")
    ag.add_argument("--gap-us", type=float, default=100.0)
    ag.add_argument("--verify", action="store_true",
                    help="demodulate the written waveform and print the "
                         "decoded frames")
    ag.set_defaults(fn=adsb_gen)
    return p


def adsb_gen(args) -> int:
    from ..signal import adsb

    try:
        group = [
            adsb.frame_identification(args.icao, args.callsign),
            adsb.frame_airborne_position(
                args.icao, args.lat, args.lon, args.alt_ft, odd=False),
            adsb.frame_airborne_position(
                args.icao, args.lat, args.lon, args.alt_ft, odd=True),
        ]
    except ValueError as e:
        print(f"adsb-gen: {e}", file=sys.stderr)
        return 2
    iq = adsb.modulate(group * args.repeat, gap_us=args.gap_us)
    with open(args.out_file, "wb") as f:
        f.write(iq.tobytes())
    dur = len(iq) / 2 / adsb.FS_ADSB
    print(f"adsb-gen: wrote {len(iq) // 2} samples ({dur * 1e3:.2f} ms) "
          f"at fs={adsb.FS_ADSB:g} -> {args.out_file}")
    print(f"# transmit (reference adsb_out.grc parameters):")
    print(f"hackrf_transfer -s {int(adsb.FS_ADSB)} "
          f"-f {int(adsb.FREQ_ADSB)} -t {args.out_file} -R")
    if args.verify:
        frames = adsb.demodulate(iq)
        print(f"# verify: {len(frames)} CRC-valid frames")
        decs = [adsb.decode_frame(fr) for fr in frames]
        for d in decs:
            print(f"#   {d}")
        pair = {d["odd"]: d["cpr"] for d in decs if "cpr" in d}
        if len(pair) == 2:
            pos = adsb.cpr_decode_global(pair[False], pair[True])
            if pos:
                print(f"#   global CPR decode: lat={pos[0]:.5f} "
                      f"lon={pos[1]:.5f}")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
