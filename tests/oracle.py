"""Independent numpy oracle for the reference acquisition math.

A deliberately naive, loop-structured float64 implementation of the
reference gps_test pipeline (reference: c/search_offline.cpp), written
directly from the algorithm spec in SURVEY.md.  Used only in tests to
cross-check the JAX implementation's decisions; shares no code with
tpu_gnss beyond the C/A tap table.
"""

from __future__ import annotations

import numpy as np


def ca_chips(t1: int, t2: int) -> np.ndarray:
    """1023 {0,1} chips via explicit two-LFSR simulation."""
    g1 = [1] * 10  # g1[0] newest ... g1[9] oldest (position 10)
    g2 = [1] * 10
    out = np.empty(1023, dtype=np.uint8)
    for k in range(1023):
        out[k] = g1[9] ^ g2[t1 - 1] ^ g2[t2 - 1]
        fb1 = g1[2] ^ g1[9]
        fb2 = g2[1] ^ g2[2] ^ g2[5] ^ g2[7] ^ g2[8] ^ g2[9]
        g1 = [fb1] + g1[:9]
        g2 = [fb2] + g2[:9]
    return out


def replica(t1: int, t2: int, fs: float, n: int) -> np.ndarray:
    """Bipolar code replica at fs with the reference's NCO/interp loop."""
    chips = ca_chips(t1, t2)
    ca_rate = 1.023e6 / fs
    out = np.empty(n, dtype=np.float64)
    phase = 0.0
    idx = 0
    for i in range(n):
        chip = 1.0 - 2.0 * chips[idx % 1023]
        phase += ca_rate
        if phase >= 1.0:
            phase -= 1.0
            idx += 1
            nxt = 1.0 - 2.0 * chips[idx % 1023]
            chip = chip * (1.0 - phase) + phase * nxt
        out[i] = chip
    return out


def mix_block(bits: np.ndarray, fc: float, fs: float) -> np.ndarray:
    """Offline-variant square-wave quadrature mix, loop form."""
    lo_sin = (1, 1, 0, 0)
    lo_cos = (0, 1, 1, 0)
    lo_rate = 4.0 * fc / fs
    phase = 0.0
    out = np.empty(len(bits), dtype=np.complex128)
    for i, b in enumerate(bits):
        p = int(phase)
        ii = -1.0 if (b ^ lo_cos[p]) else 1.0
        qq = -1.0 if (b ^ lo_sin[p]) else 1.0
        out[i] = ii + 1j * qq
        phase += lo_rate
        if phase >= 4.0:
            phase -= 4.0
    return out


def correlate(data_fft: np.ndarray, code_fft: np.ndarray, dops,
              lags: int):
    """Per-Doppler SNR search, loop form.  Returns (snr, dop, lag)."""
    best = (0.0, 0, 0)
    for dop in dops:
        prod = np.conj(data_fft) * np.roll(code_fft, dop)
        corr = np.fft.ifft(prod)
        pwr = np.abs(corr[:lags]) ** 2
        mx = pwr.max()
        snr = mx / (pwr.sum() / lags)
        if snr > best[0]:
            best = (snr, dop, int(pwr.argmax()))
    return best
