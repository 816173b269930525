"""Acquisition engine tests (CPU backend).

Oracles: the independent loop-form numpy implementation (tests/oracle.py),
the checked-in reference synthetic capture (PRN 8), and self-generated
signals with known Doppler / code phase.
"""

import numpy as np
import pytest

from tpu_gnss.config import ReceiverConfig, SYNTHETIC
from tpu_gnss.io import loaders
from tpu_gnss.acquire import search as S
from tpu_gnss.signal import cacode, synth

from . import oracle

# Small config so CPU FFTs stay fast: fs such that fft covers ~2 code periods
SMALL = ReceiverConfig(fs=2.048e6, fc=0.512e6, max_fo=5000.0, fft_len=4096)


def _acq(cfg, bits):
    s = S.Searcher(cfg)
    return s, s.acquire_bits(np.asarray(bits, np.uint8))


def test_grid_matches_oracle():
    """Batched-grid engine == loop-form oracle on the same data."""
    cfg = SMALL
    rng = np.random.default_rng(7)
    # synthesize PRN 5 with a real Doppler so the grid has structure
    sv = synth.SvSignal(prn=5, doppler_hz=1200.0, code_phase_chips=333.25)
    iq = synth.synth_baseband([sv], cfg.fs, cfg.fft_len, noise_std=1.0, seed=3)
    bits = synth.baseband_to_1bit_if(iq, cfg.fc, cfg.fs)

    mixed = oracle.mix_block(bits, cfg.fc, cfg.fs)
    data_fft = np.fft.fft(mixed)
    t1, t2 = cacode.taps(5)
    code_fft = np.fft.fft(oracle.replica(t1, t2, cfg.fs, cfg.fft_len))
    dops = range(-cfg.dop_max_bin, cfg.dop_max_bin + 1)
    want_snr, want_dop, want_lag = oracle.correlate(data_fft, code_fft, dops, cfg.lags)

    s, res = _acq(cfg, bits)
    i = 4  # PRN 5 row
    assert int(res.lo_shift[i]) == want_dop
    assert int(res.ca_shift[i]) == want_lag
    np.testing.assert_allclose(float(res.snr[i]), want_snr, rtol=2e-3)


def test_known_code_phase_and_doppler():
    cfg = SMALL
    # 2.048 Msps: one code period = 2048 samples. Put code phase at
    # 100.5 chips -> delay tau = 100.5/1023*2048 = 201.2 samples.
    dop_true = 3 * cfg.dop_bin_hz  # exactly bin 3
    sv = synth.SvSignal(prn=9, doppler_hz=dop_true, code_phase_chips=100.5)
    iq = synth.synth_baseband([sv], cfg.fs, cfg.fft_len, noise_std=0.5, seed=5)
    bits = synth.baseband_to_1bit_if(iq, cfg.fc, cfg.fs)
    s, res = _acq(cfg, bits)
    i = 8
    assert float(res.snr[i]) > 100
    assert int(res.lo_shift[i]) == 3
    # code_phase_chips=100.5 means the received code is ADVANCED by 100.5
    # chips at block start; the correlation peak sits at that advance in
    # samples (the reference's channel seeding then pauses the local code
    # NCO by period - ca_shift to align, c/channel.cpp:156-163).
    want_lag = 100.5 / 1023 * 2048  # = 201.2 samples
    assert abs(int(res.ca_shift[i]) - want_lag) <= 2


def test_no_signal_no_detection(rng):
    cfg = SMALL
    bits = rng.integers(0, 2, size=cfg.fft_len).astype(np.uint8)
    s, res = _acq(cfg, bits)
    assert s.detections(res) == []


def test_reference_fixture_prn8(synth_fixture_path):
    """Golden test vs the checked-in gps_sig_gen.m capture (PRN 8).

    Reference workflow: README §1.1 — gps_test detects the generated PRN 8
    at IF 2.046 MHz / fs 8.184 MHz.
    """
    cfg = SYNTHETIC
    bits = loaders.load_1bit(synth_fixture_path, count=cfg.fft_len)
    s, res = _acq(cfg, bits)
    snr = np.asarray(res.snr)
    assert snr[7] > 100, "PRN 8 must dominate"
    assert int(res.lo_shift[7]) == 0, "synthetic capture has zero Doppler"
    # Code starts at file start, delayed only by the rcosine group delay
    # (24 samples at 8 samples/chip) and sub-chip replica offsets: the peak
    # must be within a few samples of 8184 - 24.
    assert abs(int(res.ca_shift[7]) - (8184 - 24)) <= 8
    # block 1 prediction: stride fft_len advances code phase deterministically
    bits1 = loaders.load_1bit(synth_fixture_path, count=cfg.fft_len,
                              offset_samples=cfg.fft_len)
    _, res1 = _acq(cfg, bits1)
    assert float(res1.snr[7]) > 100
    delta = (int(res.ca_shift[7]) + cfg.fft_len - int(res1.ca_shift[7])) % 8184
    assert delta <= 2 or delta >= 8182


def test_acquire_iq_path():
    cfg = SMALL
    sv = synth.SvSignal(prn=2, doppler_hz=0.0, code_phase_chips=0.0)
    iq = synth.synth_baseband([sv], cfg.fs, cfg.fft_len, noise_std=0.2, seed=9)
    s = S.Searcher(cfg)
    res = s.acquire_iq(iq)
    assert float(res.snr[1]) > 100
    assert int(res.lo_shift[1]) == 0


def test_dop_chunk_invariance():
    """Result must not depend on the scan chunking."""
    cfg = SMALL
    sv = synth.SvSignal(prn=30, doppler_hz=-4 * cfg.dop_bin_hz, code_phase_chips=512.0)
    iq = synth.synth_baseband([sv], cfg.fs, cfg.fft_len, noise_std=1.0, seed=11)
    bits = synth.baseband_to_1bit_if(iq, cfg.fc, cfg.fs)
    outs = []
    for chunk in (1, 7, 16, cfg.num_dop_bins):
        s = S.Searcher(cfg, dop_chunk=chunk)
        res = s.acquire_bits(bits)
        outs.append((int(res.lo_shift[29]), int(res.ca_shift[29]),
                     round(float(res.snr[29]), 3)))
    assert all(o == outs[0] for o in outs)


def test_wide_doppler_grid():
    """±100 kHz replay-style grid (reference README §2.1e)."""
    cfg = ReceiverConfig(fs=2.048e6, fc=0.512e6, max_fo=100000.0, fft_len=4096)
    assert cfg.dop_max_bin == 200
    dop_true = 150 * cfg.dop_bin_hz  # 75 kHz
    sv = synth.SvSignal(prn=21, doppler_hz=dop_true, code_phase_chips=700.0)
    iq = synth.synth_baseband([sv], cfg.fs, cfg.fft_len, noise_std=0.5, seed=13)
    bits = synth.baseband_to_1bit_if(iq, cfg.fc, cfg.fs)
    s, res = _acq(cfg, bits)
    assert int(res.lo_shift[20]) == 150
    assert float(res.snr[20]) > 50


def test_nottingham_golden_reconstruction():
    """Reproduce the published Nottingham 5-SV table from a synthetic
    reconstruction of that capture.

    The real capture is a missing large blob; its golden results
    (PRN/lo_shift/ca_shift, BASELINE.md) are reconstructed here by
    synthesizing each SV at exactly the documented Doppler bin and code
    phase, then verifying the detector reports the same integers.
    """
    from tpu_gnss.config import NOTTINGHAM as cfg
    golden = [  # (prn, lo_shift, ca_shift) from BASELINE.md
        (1, 6, 1465), (21, 8, 686), (29, -9, 3868),
        (30, -9, 2998), (31, -8, 2337)]
    svs = []
    for prn, lo, ca in golden:
        svs.append(synth.SvSignal(
            prn=prn, doppler_hz=lo * cfg.dop_bin_hz,
            code_phase_chips=ca * 1023.0 / cfg.lags,
            amplitude=1.0))
    iq = synth.synth_baseband(svs, cfg.fs, cfg.fft_len, noise_std=1.5,
                              seed=29)
    bits = synth.baseband_to_1bit_if(iq, cfg.fc, cfg.fs)
    s = S.Searcher(cfg)
    res = s.acquire_bits(bits)
    for prn, lo, ca in golden:
        i = prn - 1
        assert float(res.snr[i]) >= 25, f"PRN {prn} below threshold"
        assert int(res.lo_shift[i]) == lo, f"PRN {prn} lo_shift"
        assert abs(int(res.ca_shift[i]) - ca) <= 1, f"PRN {prn} ca_shift"
