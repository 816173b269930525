"""Batched FFT acquisition (PCPS) — the reference's search stage as array work.

The reference walks a serial double loop: 32 PRNs x ~73 Doppler bins, each
doing a 40000-point spectrum shift-multiply and inverse FFT on one CPU core
(reference: c/search_offline.cpp:169-201, 219-258).  Here the whole
(PRN x Doppler) grid is one batched array program:

  corr[s, d, :] = IFFT( conj(D)[. ] * roll(C[s], d) )

with the key identity that rolling the *code* spectrum by ``d`` bins equals
rolling the *data* spectrum by ``-d`` up to a pure phase ramp in lag —
which cancels in ``|corr|``.  So the grid is computed as

  pwr[s, d, n] = | IFFT_k( roll(conj(D), -d)[k] * C[s][k] ) [n] |^2

i.e. one [n_dop, N] roll of the data spectrum broadcast against the static
[n_sv, N] code-spectrum table: no per-(sv,dop) gather, and the IFFT batch
(the only real FLOPs) maps straight onto XLA's batched FFT.  Doppler is
processed in chunks under ``lax.scan`` so HBM stays bounded for wide
(±100 kHz) grids, with a running per-SV best carried across chunks.

Detection semantics match the reference exactly: power over the first
``floor(fs/1000)`` lags, SNR = peak/average power, first-maximum tie-breaks
in both Doppler scan order (−dop_max upward) and lag order
(reference: c/search_offline.cpp:176-201).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ReceiverConfig
from ..signal import cacode


class AcqResult(NamedTuple):
    """Per-SV best over the Doppler grid.  Arrays are ``[n_sv]``."""
    snr: jnp.ndarray       # peak/avg power at best Doppler
    lo_shift: jnp.ndarray  # Doppler, FFT bins (Hz = lo_shift * fs / fft_len)
    ca_shift: jnp.ndarray  # code phase, samples within one code period


# ---------------------------------------------------------------------------
# Replica table
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def code_replicas_np(fs: float, fft_len: int,
                     prns: tuple[int, ...]) -> np.ndarray:
    """``[len(prns), fft_len]`` float32 bipolar C/A replicas sampled at fs.

    Replica construction matches the reference's SearchInit
    (reference: c/search_offline.cpp:74-110): bipolar chips resampled to fs
    with fractional-boundary interpolation.
    """
    chips = cacode.code_table()[np.array(prns) - 1]
    return cacode.resample(chips, fs, fft_len)


def code_fft_table_np(fs: float, fft_len: int,
                      prns: tuple[int, ...]) -> np.ndarray:
    """Host-side complex64 replica spectra (tests / CPU paths)."""
    return np.fft.fft(code_replicas_np(fs, fft_len, prns), axis=-1).astype(np.complex64)


def code_fft_table(cfg: ReceiverConfig) -> jnp.ndarray:
    """Device-resident ``[n_sv, fft_len]`` complex64 replica spectra.

    The FFT runs on device from float32 replicas: complex arrays never
    cross the host/device boundary (see tpu_gnss.utils.xfer).
    """
    replicas = jnp.asarray(code_replicas_np(cfg.fs, cfg.fft_len, cfg.prns))
    return jax.jit(lambda r: jnp.fft.fft(r.astype(jnp.complex64), axis=-1))(replicas)


# ---------------------------------------------------------------------------
# Device-side 1-bit mixing (fused front end)
# ---------------------------------------------------------------------------

def mix_baseband(bits: jnp.ndarray, lo_rate: float,
                 variant: str = "offline",
                 phase0_quarters=0.0) -> jnp.ndarray:
    """Device-side quadrature square-wave downconversion of {0,1} samples.

    Same math as :func:`tpu_gnss.io.loaders.mix_1bit_block`
    (reference: c/search_offline.cpp:121-165) but jit-able so the mix fuses
    into the acquisition program.  ``bits`` may be int8/uint8 {0,1}.
    ``phase0_quarters``: LO phase of the first sample in quarter cycles
    (float scalar in [0, 4), may be traced) — keeps the LO continuous
    across chunked captures.  Callers compute it on the host as
    ``(sample0 * lo_rate) % 4.0`` in float64, which stays exact for
    arbitrarily long captures (an on-device int32 sample counter would
    overflow past 2^31 samples).
    """
    from ..io.loaders import LO_TABLES
    i_tbl, q_tbl = LO_TABLES[variant]
    n = bits.shape[-1]
    # The LO phase index needs (i * lo_rate) mod 4 accurate to ~1e-4 even
    # at multi-second sample indices; plain f32 i*rate loses that, so the
    # ramp is computed with per-level range reduction (see _phase_mod4).
    i_lo = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0).squeeze(-1)
    phase = (_phase_mod4(i_lo, lo_rate)
             + jnp.asarray(phase0_quarters, jnp.float32)) % 4.0
    p = phase.astype(jnp.int32)
    s = (1 - 2 * bits.astype(jnp.int32)).astype(jnp.float32)
    itab = jnp.asarray(1.0 - 2.0 * np.asarray(i_tbl, np.float32))
    qtab = jnp.asarray(1.0 - 2.0 * np.asarray(q_tbl, np.float32))
    return (s * itab[p] + 1j * (s * qtab[p])).astype(jnp.complex64)


def _phase_mod4(i: jnp.ndarray, lo_rate: float) -> jnp.ndarray:
    """floor-free ((i * lo_rate) mod 4) with f32-safe range reduction.

    Splits i = q*K + r (K=4096) so each product stays small enough that
    float32 keeps the fractional phase accurate over multi-second blocks.
    """
    K = 4096
    q, r = i // K, i % K
    # (q*K*rate) mod 4: reduce per-part.
    part1 = (q.astype(jnp.float32) * jnp.float32((K * lo_rate) % 4.0)) % 4.0
    part2 = (r.astype(jnp.float32) * jnp.float32(lo_rate)) % 4.0
    return (part1 + part2) % 4.0


# ---------------------------------------------------------------------------
# Core grid search
# ---------------------------------------------------------------------------

def _doppler_bins(cfg: ReceiverConfig) -> np.ndarray:
    m = cfg.dop_max_bin
    return np.arange(-m, m + 1, dtype=np.int32)


def _best_over_grid(prod_fn, n_rows: int, dops: jnp.ndarray, *, lags: int,
                    dop_chunk: int) -> AcqResult:
    """Shared Doppler-grid scan: running best (SNR, dop, lag) per row.

    ``prod_fn(dop_c) -> [n_rows, chunk, N]`` builds the conjugated
    spectrum products for one chunk of Doppler bins; everything after —
    inverse FFT, the peak/avg SNR statistic over ``lags``, the
    first-max-wins tie-break and the ``>``-compare running best
    (reference: c/search_offline.cpp:169-201) — is identical for the
    full-grid and the paired engines and lives only here.
    """
    n_dop = dops.shape[0]
    pad = (-n_dop) % dop_chunk
    # Padded bins replay the last real bin; their results are masked off.
    dops_p = jnp.concatenate([dops, jnp.broadcast_to(dops[-1], (pad,))])
    valid = jnp.concatenate([jnp.ones(n_dop, bool), jnp.zeros(pad, bool)])
    chunks = dops_p.reshape(-1, dop_chunk)
    vchunks = valid.reshape(-1, dop_chunk)

    def step(carry, inp):
        best_snr, best_dop, best_lag = carry
        dop_c, valid_c = inp
        prod = prod_fn(dop_c)                      # [n_rows, chunk, N]
        corr = jnp.fft.ifft(prod, axis=-1)[..., :lags]
        pwr = corr.real**2 + corr.imag**2          # [n_rows, chunk, lags]
        max_pwr = pwr.max(axis=-1)
        max_lag = pwr.argmax(axis=-1).astype(jnp.int32)
        avg_pwr = pwr.sum(axis=-1) / lags
        snr = jnp.where(valid_c[None, :], max_pwr / avg_pwr, -jnp.inf)
        # best within chunk (first max wins, matching scan order)
        c_arg = snr.argmax(axis=-1)
        c_snr = jnp.take_along_axis(snr, c_arg[:, None], 1)[:, 0]
        c_dop = dop_c[c_arg]
        c_lag = jnp.take_along_axis(max_lag, c_arg[:, None], 1)[:, 0]
        upd = c_snr > best_snr
        return (jnp.where(upd, c_snr, best_snr),
                jnp.where(upd, c_dop, best_dop),
                jnp.where(upd, c_lag, best_lag)), None

    init = (jnp.full((n_rows,), -jnp.inf, jnp.float32),
            jnp.zeros((n_rows,), jnp.int32),
            jnp.zeros((n_rows,), jnp.int32))
    (snr, dop, lag), _ = jax.lax.scan(step, init, (chunks, vchunks))
    return AcqResult(snr, dop, lag)


@functools.partial(jax.jit, static_argnames=("lags", "dop_chunk"))
def acquire_from_fft(data_fft: jnp.ndarray, code_ffts: jnp.ndarray,
                     dops: jnp.ndarray, *, lags: int,
                     dop_chunk: int = 16) -> AcqResult:
    """Search the full (SV x Doppler) grid for one data block.

    Args:
      data_fft: ``[fft_len]`` complex64 forward FFT of the mixed block.
      code_ffts: ``[n_sv, fft_len]`` complex64 replica spectra.
      dops: ``[n_dop]`` int32 Doppler bin shifts, scanned in order
        (ties keep the earliest, matching the reference's ``>`` compare).
      lags: code-phase lags scored = floor(fs/1000).
      dop_chunk: Doppler bins per scan step (memory knob).
    """
    conj_d = jnp.conj(data_fft)

    def prod_fn(dop_c):
        # [chunk, N] data spectrum rolled by -dop
        dshift = jax.vmap(lambda d: jnp.roll(conj_d, -d))(dop_c)
        return code_ffts[:, None, :] * dshift[None, :, :]

    return _best_over_grid(prod_fn, code_ffts.shape[0], dops,
                           lags=lags, dop_chunk=dop_chunk)


@functools.partial(jax.jit, static_argnames=("lo_rate", "lags", "dop_chunk", "variant"))
def acquire_bits_block(bits: jnp.ndarray, code_ffts: jnp.ndarray,
                       dops: jnp.ndarray, *, lo_rate: float, lags: int,
                       dop_chunk: int = 16,
                       variant: str = "offline") -> AcqResult:
    """Fused front end: {0,1} IF bits -> mix -> FFT -> grid search."""
    iq = mix_baseband(bits, lo_rate, variant)
    data_fft = jnp.fft.fft(iq)
    return acquire_from_fft(data_fft, code_ffts, dops,
                            lags=lags, dop_chunk=dop_chunk)


@functools.partial(jax.jit, static_argnames=("lags", "dop_chunk"))
def acquire_paired(data_ffts: jnp.ndarray, code_ffts: jnp.ndarray,
                   dops: jnp.ndarray, *, lags: int,
                   dop_chunk: int = 16) -> AcqResult:
    """Diagonal variant: pair i searches data block i against code i.

    Reproduces the reference CLI's block consumption pattern, where the
    PRN sweep reads a fresh 40000-sample block per SV
    (reference: c/search_offline.cpp:239-246): batch the 32 per-run blocks
    and correlate block i with SV i only.

    Args: ``data_ffts``/``code_ffts`` are ``[B, fft_len]`` complex64.
    """
    conj_d = jnp.conj(data_ffts)                       # [B, N]

    def prod_fn(dop_c):
        # [B, chunk, N]: per-pair data spectrum rolled by -dop
        dshift = jax.vmap(lambda d: jnp.roll(conj_d, -d, axis=-1),
                          out_axes=1)(dop_c)
        return code_ffts[:, None, :] * dshift

    return _best_over_grid(prod_fn, data_ffts.shape[0], dops,
                           lags=lags, dop_chunk=dop_chunk)


@functools.partial(jax.jit, static_argnames=("lags",))
def acquire_grid_pwr(data_fft: jnp.ndarray, code_fft: jnp.ndarray,
                     dops: jnp.ndarray, *, lags: int) -> jnp.ndarray:
    """Full ``[n_dop, lags]`` power map for one SV (diagnostics/tests)."""
    conj_d = jnp.conj(data_fft)

    def one(d):
        corr = jnp.fft.ifft(jnp.roll(conj_d, -d) * code_fft)[:lags]
        return corr.real**2 + corr.imag**2

    return jax.vmap(one)(dops)


@functools.partial(jax.jit, static_argnames=("lo_rate", "variant"))
def _mix_fft_blocks(bits_blocks: jnp.ndarray, lo_rate: float,
                    variant: str = "offline") -> jnp.ndarray:
    """[B, N] {0,1} bits -> mixed -> per-block forward FFT (phase resets)."""
    iq = mix_baseband(bits_blocks, lo_rate, variant)
    return jnp.fft.fft(iq, axis=-1)


# ---------------------------------------------------------------------------
# High-level engine
# ---------------------------------------------------------------------------

class Searcher:
    """Acquisition engine bound to one capture configuration.

    Holds the device-resident replica spectrum table and Doppler grid and
    exposes block-level and capture-level search.  The equivalent of the
    reference's SearchInit + SearchTask pair
    (reference: c/search_offline.cpp:74-110, 219-292).
    """

    def __init__(self, cfg: ReceiverConfig, dop_chunk: Optional[int] = None):
        self.cfg = cfg
        self.code_ffts = code_fft_table(cfg)
        self.dops = jnp.asarray(_doppler_bins(cfg))
        if dop_chunk is None:
            # ~256 MB of complex64 per chunk buffer, clamped to the grid.
            budget = max(1, (256 << 20) // (len(cfg.prns) * cfg.fft_len * 8))
            dop_chunk = int(min(max(budget, 1), cfg.num_dop_bins))
        self.dop_chunk = dop_chunk

    # -- block level -------------------------------------------------------

    def _check_len(self, n: int) -> None:
        if n != self.cfg.fft_len:
            raise ValueError(
                f"block must have exactly fft_len={self.cfg.fft_len} samples, "
                f"got {n}; pad or re-block the capture")

    def acquire_bits(self, bits) -> AcqResult:
        """Search one fft_len block of {0,1} IF samples (all PRNs)."""
        bits = jnp.asarray(bits, dtype=jnp.uint8)
        self._check_len(bits.shape[-1])
        return acquire_bits_block(
            bits, self.code_ffts, self.dops, lo_rate=self.cfg.lo_rate,
            lags=self.cfg.lags, dop_chunk=self.dop_chunk)

    def acquire_iq(self, iq) -> AcqResult:
        """Search one fft_len block of complex baseband samples.

        ``iq`` may be a host numpy complex array (transferred as float32
        planes — complex never crosses the host/device boundary) or an
        on-device complex array.
        """
        self._check_len(np.shape(iq)[-1])
        if isinstance(iq, np.ndarray):
            from ..utils.xfer import to_device_complex
            iq = to_device_complex(iq)
        data_fft = jnp.fft.fft(iq.astype(jnp.complex64))
        return acquire_from_fft(data_fft, self.code_ffts, self.dops,
                                lags=self.cfg.lags, dop_chunk=self.dop_chunk)

    def acquire_bits_paired(self, bits_blocks) -> AcqResult:
        """Compat path: block i is searched against PRN ``prns[i]`` only.

        ``bits_blocks``: ``[n_sv, fft_len]`` {0,1} samples; the LO phase
        restarts at each block start (each reference Sample() call does,
        reference: c/search_offline.cpp:131).
        """
        bits_blocks = jnp.asarray(bits_blocks, dtype=jnp.uint8)
        assert bits_blocks.shape == (len(self.cfg.prns), self.cfg.fft_len)
        data_ffts = _mix_fft_blocks(bits_blocks, self.cfg.lo_rate)
        return acquire_paired(data_ffts, self.code_ffts, self.dops,
                              lags=self.cfg.lags, dop_chunk=self.dop_chunk)

    def detections(self, res: AcqResult) -> list[dict]:
        """Threshold an AcqResult into detection records (host-side)."""
        snr = np.asarray(res.snr)
        lo = np.asarray(res.lo_shift)
        ca = np.asarray(res.ca_shift)
        out = []
        for i, prn in enumerate(self.cfg.prns):
            if snr[i] >= self.cfg.snr_threshold:
                out.append(dict(prn=prn, sv=prn - 1, snr=float(snr[i]),
                                lo_shift=int(lo[i]), ca_shift=int(ca[i]),
                                doppler_hz=float(lo[i]) * self.cfg.dop_bin_hz))
        return out
