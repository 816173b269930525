"""Chunked grid reduce (the refined cold search's grid stage) and the
four-step DFT factorization of the tracking correlator.

The per-chunk peak/lag/total reduce must reproduce a float64 np.fft
oracle of the same wiped, zero-padded circular correlation, and the
one-program refined search must make the same decisions as the full
power-grid path it replaces on the cold-start critical path.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from tpu_gnss.config import ReceiverConfig
from tpu_gnss.acquire import folded as F
from tpu_gnss.signal import synth
from tpu_gnss.track.channel import split_nf


def test_split_nf():
    assert split_nf(16384) == (128, 128)
    assert split_nf(1024) == (8, 128)
    assert split_nf(10000) == (100, 100)
    with pytest.raises(ValueError):
        split_nf(9973)  # prime


def _oracle_power(x, code, dops, fs, nf, period):
    """float64 |circ corr|^2 ``[B, sv, dop, P]`` of wiped blocks ``x``."""
    n = np.arange(period)
    wipe = np.exp(-2j * np.pi * np.outer(dops, n) / fs)      # [dop, P]
    g = np.fft.fft(x[:, None, :] * wipe[None], n=nf, axis=-1)
    lin = np.fft.ifft(code[None, :, None, :] * np.conj(g)[:, None],
                      axis=-1)
    circ = (lin[..., :period] + lin[..., nf - period:]
            if nf != period else lin[..., :period])
    return np.abs(circ) ** 2


def _plain_reduce(x, code, dops, fs, period, accumulate):
    return F._corr_reduce_grid(
        jnp.asarray(x.astype(np.complex64)),
        jnp.asarray(code.astype(np.complex64)),
        jnp.asarray(np.asarray(dops, np.float32)), fs=fs, n_coherent=1,
        dop_chunk=2, period=period, accumulate=accumulate)


def test_fold_corr_reduce_matches_numpy():
    """Wipe + padded FFT + product + inverse + reduce vs np.fft oracle,
    with NF > P so the circular wrap of the linear correlation is
    exercised, and an odd Doppler count so chunk padding is too."""
    rng = np.random.default_rng(2)
    nf, period, n_sv, rows = 1024, 1000, 4, 5
    fs = period * 1000.0
    dops = [-500.0, 0.0, 700.0]
    x = (rng.standard_normal((rows, period))
         + 1j * rng.standard_normal((rows, period)))
    code = (rng.standard_normal((n_sv, nf))
            + 1j * rng.standard_normal((n_sv, nf)))
    pw = _oracle_power(x, code, dops, fs, nf, period)      # [B, sv, d, P]
    peak, lag, tot = (np.asarray(a)[..., :len(dops)] for a in
                      _plain_reduce(x, code, dops, fs, period, False))
    assert peak.shape == (rows, n_sv, len(dops))
    assert (lag == pw.argmax(-1)).all()
    np.testing.assert_allclose(peak, pw.max(-1), rtol=1e-3)
    np.testing.assert_allclose(tot, pw.sum(-1), rtol=1e-3)


def test_fold_corr_reduce_noncoherent():
    """accumulate=True sums |corr|^2 across blocks before the reduce."""
    rng = np.random.default_rng(5)
    nf = period = 1024
    fs = period * 1000.0
    n_sv, n_acc = 2, 3
    dops = [0.0, 250.0]
    x = (rng.standard_normal((n_acc, period))
         + 1j * rng.standard_normal((n_acc, period)))
    code = (rng.standard_normal((n_sv, nf))
            + 1j * rng.standard_normal((n_sv, nf)))
    pw = _oracle_power(x, code, dops, fs, nf, period).sum(0)   # [sv, d, P]
    peak, lag, tot = (np.asarray(a) for a in
                      _plain_reduce(x, code, dops, fs, period, True))
    assert peak.shape == (1, n_sv, len(dops))
    assert (lag[0] == pw.argmax(-1)).all()
    np.testing.assert_allclose(peak[0], pw.max(-1), rtol=1e-3)
    np.testing.assert_allclose(tot[0], pw.sum(-1), rtol=1e-3)


def test_detections_refined_fast_matches_grid_refine():
    """Chunked detect + window refine == full-grid refine on one scene."""
    cfg = ReceiverConfig(fs=1.024e6, fc=0.256e6, max_fo=5000.0,
                         fft_len=4096)
    s = F.FoldedSearcher(cfg, n_coherent=4, dop_chunk=8)
    svs = [synth.SvSignal(prn=7, doppler_hz=1840.0,
                          code_phase_chips=303.4)]
    iq = synth.synth_baseband(svs, cfg.fs, s.block_len, noise_std=0.4,
                              seed=7)
    want = s.detections_refined(s.power_grid(iq=iq))
    got = s.detections_refined_fast(iq=iq)
    assert [d["prn"] for d in got] == [d["prn"] for d in want] == [7]
    w, g = want[0], got[0]
    assert abs(g["doppler_hz"] - w["doppler_hz"]) < 1.0
    assert abs(g["ca_shift"] - w["ca_shift"]) < 0.05
    np.testing.assert_allclose(g["snr"], w["snr"], rtol=1e-4)


def test_detections_refined_fast_prn_subset():
    """Refined-fast must index power-grid rows by cfg.prns position, not
    by sv number (regression: d['sv'] = prn-1 was used as the row)."""
    import dataclasses
    from tpu_gnss.config import SYNTHETIC
    from tpu_gnss.signal import synth
    cfg = dataclasses.replace(SYNTHETIC, prns=(7, 8, 21))
    s = F.FoldedSearcher(cfg, n_coherent=4)
    sv = synth.SvSignal(prn=8, doppler_hz=409.2, code_phase_chips=512.0)
    iq = synth.synth_baseband([sv], cfg.fs, s.block_len, noise_std=0.1,
                              seed=3)
    dets = s.detections_refined_fast(iq=iq)
    assert [d["prn"] for d in dets] == [8]
    assert abs(dets[0]["doppler_hz"] - 409.2) < 80.0

def test_detections_refined_fast_zero_head_no_nan_detections():
    """An all-zero head (dropout segment) must yield NO detections.

    SNR = 0/0 = NaN there; the inclusion test must be NaN-safe
    (regression: `snr < thr: continue` let every NaN through and seeded
    the whole channel bank with garbage)."""
    cfg = ReceiverConfig(fs=1.024e6, fc=0.256e6, max_fo=5000.0,
                         fft_len=4096)
    s = F.FoldedSearcher(cfg, n_coherent=4, dop_chunk=8)
    iq = np.zeros(s.block_len, np.complex64)
    assert s.detections_refined_fast(iq=iq) == []
