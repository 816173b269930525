"""Software replay loop tests (the RF playback path without radios).

Mirrors the reference's generate -> transmit -> capture -> re-receive
cycle (README.md §2.2): synthesize the PRN-8 TX file, replay it through
the channel model with a large oscillator offset, hard-limit back to a
1-bit IF capture, and re-acquire with a wide Doppler grid.
"""

import numpy as np
import pytest

from tpu_gnss.config import ReceiverConfig
from tpu_gnss.io import loaders
from tpu_gnss.signal import rfchannel, synth
from tpu_gnss.cli import playback


FS = 8.184e6
FC = 2.046e6


def _make_tx(tmp_path):
    bits, meta = synth.synth_1bit_if(num_bits=6)
    one = tmp_path / "tx_1bit.bin"
    one.write_bytes(loaders.pack_1bit(bits))
    tx = tmp_path / "tx_iq8.bin"
    loaders.convert_1bit_to_iq8(str(one), str(tx), fs=FS)
    return tx


def test_apply_channel_offsets_are_exact():
    fs = 1e6
    n = 4096
    t = np.arange(n) / fs
    tone = np.exp(2j * np.pi * 1000.0 * t).astype(np.complex64)
    out = rfchannel.apply_channel(tone, fs, freq_offset_hz=2500.0,
                                  gain=2.0, phase_rad=0.5)
    want = 2.0 * np.exp(1j * (2 * np.pi * 3500.0 * t + 0.5))
    assert np.allclose(out, want, atol=1e-3)
    # integer delay shifts samples; head zero-filled
    d = rfchannel.apply_channel(tone, fs, delay_samples=7)
    assert np.allclose(d[7:], tone[:-7], atol=1e-6)
    assert np.all(d[:7] == 0)
    # fractional delay = linear interpolation between neighbors
    h = rfchannel.apply_channel(tone, fs, delay_samples=2.5)
    want = 0.5 * (tone[:-3] + tone[1:-2])
    assert np.allclose(h[3:], want, atol=1e-5)


def test_loopback_reacquires_with_oscillator_offset(tmp_path, capsys):
    """Replayed capture is re-acquired; Doppler shows the TX/RX offset."""
    tx = _make_tx(tmp_path)
    out = tmp_path / "rx_1bit.bin"
    rc = playback.main([
        "loopback", str(tx), str(out),
        "--fs-tx", str(FS), "--fc-rx", str(FC),
        "--freq-offset", "8000", "--delay", "1234", "--noise", "0.3",
        "--acquire", "--max-fo", "20000"])
    assert rc == 0
    text = capsys.readouterr().out
    assert "loopback: wrote" in text

    cfg = ReceiverConfig(fs=FS, fc=FC, max_fo=20000.0)
    from tpu_gnss.acquire.search import Searcher
    bits = loaders.load_1bit(str(out), count=cfg.fft_len)
    s = Searcher(cfg)
    dets = s.detections(s.acquire_bits(bits))
    assert dets, "replayed PRN-8 must be re-acquired"
    top = max(dets, key=lambda d: d["snr"])
    assert top["prn"] == 8
    # the 8 kHz oscillator offset must land in the right Doppler bin
    assert abs(abs(top["doppler_hz"]) - 8000.0) < 2 * cfg.dop_bin_hz


def test_plan_prints_hackrf_invocation(capsys):
    rc = playback.main(["plan", "gps_sig_tmp_for_hackrf_tx.bin",
                        "--profile", "synthetic"])
    assert rc == 0
    text = capsys.readouterr().out
    assert "hackrf_transfer -s 8184000 -f 1575420000" in text
    assert "rf_gain = 10" in text
    # wav profile follows hackrf_transfer_script.txt (2.8 Msps, 1574.8 MHz)
    playback.main(["plan", "x.bin", "--profile", "wav"])
    text = capsys.readouterr().out
    assert "hackrf_transfer -s 2800000 -f 1574800000" in text


def test_plan_emits_grc_flowgraph(tmp_path, capsys):
    """--grc writes a loadable GRC 3.8 YAML with the reference TX chain."""
    from tpu_gnss.cli.playback import main
    out = tmp_path / "tx.grc"
    main(["plan", "tx.bin", "--profile", "nottingham",
          "--grc", str(out)])
    import yaml
    d = yaml.safe_load(out.read_text())
    names = {b["name"]: b for b in d["blocks"]}
    # the reference chain: file_source -> deinterleave -> 2x c2f -> f2c
    # -> osmosdr sink (gps_Nottingham.grc parameters)
    assert names["src"]["id"] == "blocks_file_source"
    assert names["sink"]["id"] == "osmosdr_sink"
    assert names["sink"]["parameters"]["center_freq0"] == "1575420000"
    assert names["samp_rate"]["parameters"]["value"] == "5456000"
    assert len(d["connections"]) == 6


def test_plan_adsb_profile(tmp_path, capsys):
    """SURVEY §2.3 row: the reference's ADS-B side experiment
    (adsb/adsb_out.grc — same TX chain at 2 Msps / 1176.45 MHz) is
    covered by the 'adsb' profile in both the hackrf_transfer plan and
    the emitted GRC flowgraph."""
    playback.main(["plan", "adsb_for_hackrf.bin", "--profile", "adsb"])
    text = capsys.readouterr().out
    assert "hackrf_transfer -s 2000000 -f 1176450000" in text
    out = tmp_path / "adsb.grc"
    playback.main(["plan", "adsb_for_hackrf.bin", "--profile", "adsb",
                   "--grc", str(out)])
    import yaml
    d = yaml.safe_load(out.read_text())
    names = {b["name"]: b for b in d["blocks"]}
    assert names["sink"]["parameters"]["center_freq0"] == "1176450000"
    assert names["samp_rate"]["parameters"]["value"] == "2000000"


# ---------------------------------------------------------------------------
# ADS-B waveform synthesis / decode (signal/adsb.py)
# ---------------------------------------------------------------------------

def _hexbits(h):
    v = int(h, 16)
    n = len(h) * 4
    return np.array([(v >> (n - 1 - i)) & 1 for i in range(n)], np.uint8)


def test_adsb_crc_and_decode_golden_vectors():
    """Mode S CRC-24 + field decode against well-known published
    example messages (mode-s.org / DO-260B worked examples): a DF17
    identification frame and a CPR even/odd airborne-position pair."""
    from tpu_gnss.signal import adsb

    ident = _hexbits("8D4840D6202CC371C32CE0576098")
    assert adsb.crc24(ident) == 0
    d = adsb.decode_frame(ident)
    assert d["df"] == 17 and d["icao"] == 0x4840D6
    assert d["callsign"] == "KLM1023"

    even = _hexbits("8D40621D58C382D690C8AC2863A7")
    odd = _hexbits("8D40621D58C386435CC412692AD6")
    assert adsb.crc24(even) == 0 and adsb.crc24(odd) == 0
    de, do = adsb.decode_frame(even), adsb.decode_frame(odd)
    assert de["alt_ft"] == 38000 and not de["odd"] and do["odd"]
    lat, lon = adsb.cpr_decode_global(de["cpr"], do["cpr"])
    assert abs(lat - 52.2572) < 1e-3 and abs(lon - 3.91937) < 1e-3


def test_adsb_waveform_roundtrip(tmp_path):
    """Frame -> 2 Msps PPM int8 I/Q (the adsb_for_hackrf.bin format the
    reference flowgraph streams) -> demod -> decode recovers the
    callsign, altitude, and globally-decoded CPR position."""
    from tpu_gnss.signal import adsb

    icao, lat0, lon0 = 0x3C6444, 51.9, -1.25
    frames = [
        adsb.frame_identification(icao, "GNSS9TST"),
        adsb.frame_airborne_position(icao, lat0, lon0, 12000, odd=False),
        adsb.frame_airborne_position(icao, lat0, lon0, 12000, odd=True),
    ]
    iq = adsb.modulate(frames)
    got = [adsb.decode_frame(fr) for fr in adsb.demodulate(iq)]
    assert len(got) == 3
    assert got[0]["callsign"] == "GNSS9TST"
    assert all(g["icao"] == icao for g in got)
    assert got[1]["alt_ft"] == 12000
    lat, lon = adsb.cpr_decode_global(got[1]["cpr"], got[2]["cpr"])
    # 17-bit CPR quantization: ~5e-5 deg latitude
    assert abs(lat - lat0) < 1e-3 and abs(lon - lon0) < 1e-3


def test_adsb_gen_cli(tmp_path, capsys):
    """adsb-gen writes a playable waveform file and --verify round-trips
    it through the software demodulator."""
    out = tmp_path / "adsb_for_hackrf.bin"
    rc = playback.main([
        "adsb-gen", str(out), "--icao", "ABCDEF", "--callsign", "GNSSRX1",
        "--lat", "52.25", "--lon", "4.0", "--alt-ft", "38000", "--verify"])
    assert rc == 0
    text = capsys.readouterr().out
    assert "hackrf_transfer -s 2000000 -f 1176450000" in text
    assert "3 CRC-valid frames" in text
    assert "GNSSRX1" in text and "lat=52.25" in text
    raw = np.fromfile(out, dtype=np.int8)
    assert len(raw) % 2 == 0 and np.abs(raw).max() == 100
    assert np.all(raw[1::2] == 0)  # Q rail idle, OOK on I


def test_adsb_input_validation(tmp_path, capsys):
    """Out-of-range altitude and non-charset callsigns are rejected
    (wrapping would silently broadcast a wrong altitude; '#' is the
    invalid-character placeholder, not a legal callsign char)."""
    from tpu_gnss.signal import adsb

    with pytest.raises(ValueError, match="50175"):
        adsb.frame_airborne_position(0xABCDEF, 52.0, 4.0, 60000, odd=False)
    with pytest.raises(ValueError, match="AIR-25"):
        adsb.frame_identification(0xABCDEF, "AIR-25")
    with pytest.raises(ValueError, match="callsign"):
        adsb.frame_identification(0xABCDEF, "AB#")
    # CLI surfaces it as a clean error, not a traceback
    rc = playback.main(["adsb-gen", str(tmp_path / "x.bin"),
                        "--callsign", "AIR-25"])
    assert rc == 2
    assert "callsign" in capsys.readouterr().err
