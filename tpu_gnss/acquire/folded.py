"""Folded (coherent-integration) acquisition engine — the fast native path.

The reference correlates each 40000-sample block directly: per Doppler bin,
a 40000-point spectrum product + inverse FFT, even though only one code
period (fs/1000 samples) of lags is meaningful
(reference: c/search_offline.cpp:169-201).  This engine restructures the
same search as batched array work:

1. **Exact Doppler wipe-off**: mix the block by ``exp(-j2π f t)`` for every
   candidate Doppler (a batched elementwise product), instead of
   integer-bin spectrum rolls.
2. **Coherent folding**: the mixed block, an integer number of code
   periods long, is folded (reshape + sum) onto one period.  Correlation
   against the period-P replica then needs only P-point FFTs — ~5x less
   transform work than the reference-shaped grid for a 4-period block.
3. **Non-coherent accumulation**: power grids from successive blocks can
   be summed, raising sensitivity below the single-block threshold — a
   capability the reference lacks entirely.

Semantics: SNR = peak/avg power over the P lags of one code period, the
same detector statistic as the reference; ``ca_shift`` has the identical
meaning (code advance in samples at block start).  Doppler is searched on
an arbitrary Hz grid (default: the reference's bin spacing fs/40000).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ReceiverConfig
from ..signal import cacode
from .search import mix_baseband


class FoldedResult(NamedTuple):
    """Per-SV best over the Doppler grid (arrays ``[n_sv]``)."""
    snr: jnp.ndarray        # peak/avg power at best Doppler
    doppler_hz: jnp.ndarray # best Doppler, Hz (float32)
    ca_shift: jnp.ndarray   # code phase advance, samples in [0, P)


@functools.lru_cache(maxsize=8)
def period_replicas_np(fs: float, prns: tuple[int, ...]) -> np.ndarray:
    """``[n_sv, P]`` float32 one-period bipolar replicas, P = fs/1000."""
    p = int(fs / 1000)
    chips = cacode.code_table()[np.array(prns) - 1]
    return cacode.resample(chips, fs, p)


@functools.partial(jax.jit, static_argnames=("nf",))
def _fft_replicas(replicas: jnp.ndarray, nf: int) -> jnp.ndarray:
    return jnp.fft.fft(replicas.astype(jnp.complex64), n=nf, axis=-1)


@functools.lru_cache(maxsize=8)
def _code_ffts_device(fs: float, prns: tuple, nf: int):
    """Device-resident replica spectra, shared across searcher instances.

    A fresh Receiver/FoldedSearcher per run must not pay the replica
    upload + FFT again; the spectra depend only on (fs, prns, nf).
    """
    replicas = jnp.asarray(period_replicas_np(fs, tuple(prns)))
    out = _fft_replicas(replicas, nf)
    out.block_until_ready()
    return out


def _smooth_2_5(n: int) -> bool:
    """True if n factors into 2s and 5s only."""
    for f in (2, 5):
        while n % f == 0:
            n //= f
    return n == 1


def fft_len_for_period(p: int) -> int:
    """Transform length for a period-P circular correlation.

    P itself when 2/5-smooth (direct circular FFT is native-radix fast);
    otherwise the next power of two >= 2P-1 — the P-point circular
    correlation is then recovered exactly from the zero-padded LINEAR
    correlation by wrapping: circ[n] = lin[n] + lin[n-P].  This keeps
    awkward sizes (e.g. 8184 = 2^3*3*11*31) off the FFT libraries' slow
    large-prime paths at the price of a ~2x longer transform.
    """
    if _smooth_2_5(p):
        return p
    nf = 1
    while nf < 2 * p - 1:
        nf *= 2
    return nf


def doppler_grid_hz(cfg: ReceiverConfig,
                    spacing_hz: Optional[float] = None) -> np.ndarray:
    """Doppler grid in Hz; default spacing matches the reference bins."""
    step = spacing_hz if spacing_hz is not None else cfg.dop_bin_hz
    m = int(cfg.max_fo / step)
    return (np.arange(-m, m + 1, dtype=np.float64) * step).astype(np.float32)


def noncoherent_threshold(t1: float, k: int) -> float:
    """Equal-false-alarm SNR threshold for a k-block accumulated grid.

    The peak/avg statistic CONCENTRATES with non-coherent accumulation:
    a mean-normalized noise cell of the k-sum grid is chi^2_{2k}/(2k)
    (exponential at k=1), so a threshold held constant at the k=1 value
    ``t1`` throws away most of the accumulation's sensitivity gain —
    the weak signal has to stand at t1 even though the noise floor's
    maxima have shrunk severalfold.  This returns the chi^2_{2k}
    tail-matched threshold: same per-cell false-alarm probability
    exp(-t1) as the k=1 detector.  Measured on the real engine (32 SVs
    x full grid, noise only): maxima 13.3-16.0 at k=1 (t=25),
    3.7-4.2 at k=8 (T=5.37) — the relative margin is preserved.
    """
    if k <= 1:
        return float(t1)
    p = math.exp(-float(t1))
    try:
        from scipy.stats import chi2
        return float(chi2.isf(p, 2 * k) / (2 * k))
    except ImportError:
        # Wilson-Hilferty approximation (high of exact, i.e.
        # conservative: ~+15% at k=2, shrinking to <= ~7% by k>=4 —
        # measured by test_noncoherent_threshold_false_alarm_equalized):
        # chi2_isf(p, v) ~= v * (1 - 2/(9v) + z_p * sqrt(2/(9v)))^3
        from statistics import NormalDist
        v = 2.0 * k
        z = NormalDist().inv_cdf(1.0 - p)
        return float(v * (1.0 - 2.0 / (9 * v)
                          + z * math.sqrt(2.0 / (9 * v))) ** 3 / v)


# Near-far cross-correlation guard for accumulated (k>1) detections.
# The chi^2 threshold above models THERMAL noise, but a strong in-band
# signal's C/A cross-correlation floor is deterministic: it accumulates
# coherently while noise averages down, so at k=4 a pair of SNR ~500
# signals lifts EVERY other PRN's accumulated peak/avg to ~10-13 —
# above the k=4 threshold of 8.5 (measured).  Worst-case C/A
# cross-correlation is -21.1 dB (-18 dB at adverse Doppler offsets);
# detections more than ~13 dB below the sweep's strongest signal are
# inside that ambiguity and untrustworthy (the protection real
# receivers apply).  The k=1 threshold of 25 needs no guard: the
# reference chose it to sit above the single-block cross floor.
#
# SENSITIVITY CAP (accepted trade-off): because the guard floor scales
# with the sweep's strongest SNR, an accumulated (k>1) sweep in a
# strong-signal scene cannot report genuine SVs >13 dB below the
# strongest — they are indistinguishable from its cross floor without
# the stronger signal's cancellation, which this engine does not
# attempt.  In a DIRECTED subset sweep the reference maximum spans only
# the swept PRNs, so a strong out-of-subset SV does not raise the
# guard; the receiver mitigates by retiring the directed searcher
# after the cold start (receiver._cold_detections) so steady-state
# re-acquisition always sweeps — and guards against — the full
# constellation.
CROSS_GUARD = 1.0 / 20.0


def _near_far_ok(snr: float, snr_max: float, k: int) -> bool:
    return k <= 1 or snr >= snr_max * CROSS_GUARD


@functools.partial(jax.jit,
                   static_argnames=("fs", "n_coherent", "dop_chunk",
                                    "period"))
def fold_power_grid(iq: jnp.ndarray, code_ffts_p: jnp.ndarray,
                    dops_hz: jnp.ndarray, *, fs: float, n_coherent: int,
                    dop_chunk: int = 64,
                    period: int = 0) -> jnp.ndarray:
    """Power grid ``[n_sv, n_dop, P]`` for one coherent block.

    ``iq``: ``[n_coherent * P]`` complex baseband samples.
    ``code_ffts_p``: ``[n_sv, NF]`` replica spectra at the (possibly
    padded) transform length from :func:`fft_len_for_period`.
    ``period``: P = fs/1000 (defaults to the transform length).
    """
    pwr = fold_power_grid_batch(iq[None, :], code_ffts_p, dops_hz, fs=fs,
                                n_coherent=n_coherent, dop_chunk=dop_chunk,
                                period=period)
    return pwr[0]


def _fold_maker(iq_blocks: jnp.ndarray, *, fs: float, n_coherent: int,
                period: int, dop_chunk: int):
    """Shared wipe-off/fold prologue of the folded engines.

    Exact wipe-off + fold as one small matmul: phase is additive over
    periods, ``e^(-j2πf(cP+m)/fs) = E[f,c] * e_m[f,m]``, so
    ``folded[f,m] = e_m[f,m] * Σ_c E[f,c] iq[cP+m]`` — the Σ_c is a
    [chunk, NC] x [NC, P] complex matmul instead of materializing a
    [chunk, n] mixed array per Doppler.  ``e_m`` itself is built from
    K + P/K trig evaluations via the same phase split.

    Returns ``fold(dop_c [chunk]) -> x [B, chunk, P]``, the wiped+folded
    time-domain blocks.
    """
    b = iq_blocks.shape[0]
    n = n_coherent * period
    iqp = iq_blocks[:, :n].reshape(b, n_coherent, period)
    c_t = jnp.arange(n_coherent, dtype=jnp.float32) * (period / fs)
    K = 256
    njp = -(-period // K)
    i_t = jnp.arange(K, dtype=jnp.float32) / jnp.float32(fs)
    j_t = jnp.arange(njp, dtype=jnp.float32) * (K / fs)

    def fold(dop_c):
        ph_c = -2.0 * jnp.pi * dop_c[:, None] * c_t[None, :]
        e_c = jax.lax.complex(jnp.cos(ph_c), jnp.sin(ph_c))  # [chunk, NC]
        ph_a = -2.0 * jnp.pi * dop_c[:, None] * i_t[None, :]
        ph_b = -2.0 * jnp.pi * dop_c[:, None] * j_t[None, :]
        aa = jax.lax.complex(jnp.cos(ph_a), jnp.sin(ph_a))   # [chunk, K]
        bb = jax.lax.complex(jnp.cos(ph_b), jnp.sin(ph_b))   # [chunk, njp]
        e_m = (bb[:, :, None] * aa[:, None, :]).reshape(
            dop_chunk, njp * K)[:, :period]                  # [chunk, P]
        # explicit precision: a float32/complex64 product may otherwise
        # run in TF32 on the GPU (~3 decimal digits); the contraction is
        # only n_coherent long, so full precision costs nothing
        base = jnp.einsum("dc,bcm->bdm", e_c, iqp,
                          precision=jax.lax.Precision.HIGHEST)  # [B, chunk, P]
        return e_m[None, :, :] * base

    return fold


def _fold_fft_maker(iq_blocks: jnp.ndarray, *, fs: float, n_coherent: int,
                    period: int, nf: int, dop_chunk: int):
    """Wipe/fold prologue + forward FFT (the XLA engine's spectra)."""
    fold = _fold_maker(iq_blocks, fs=fs, n_coherent=n_coherent,
                       period=period, dop_chunk=dop_chunk)
    return lambda dop_c: jnp.fft.fft(fold(dop_c), n=nf, axis=-1)


def _chunk_power(f: jnp.ndarray, code_ffts_p: jnp.ndarray,
                 period: int) -> jnp.ndarray:
    """``|corr|²`` ``[B, sv, chunk, P]`` from the spectra ``f``
    ``[B, chunk, NF]`` of one Doppler chunk: spectrum product, inverse
    FFT, and the circular wrap of the zero-padded linear correlation
    (``circ[τ] = lin[τ] + lin[τ-P]``, :func:`fft_len_for_period`)."""
    nf = f.shape[-1]
    prod = code_ffts_p[None, :, None, :] * jnp.conj(f)[:, None, :, :]
    lin = jnp.fft.ifft(prod, axis=-1)                    # [B, sv, chunk, NF]
    corr = (lin[..., :period] if nf == period
            else lin[..., :period] + lin[..., nf - period:])
    return corr.real ** 2 + corr.imag ** 2


@functools.partial(jax.jit,
                   static_argnames=("fs", "n_coherent", "dop_chunk",
                                    "period"))
def fold_power_grid_batch(iq_blocks: jnp.ndarray, code_ffts_p: jnp.ndarray,
                          dops_hz: jnp.ndarray, *, fs: float,
                          n_coherent: int,
                          dop_chunk: int = 64,
                          period: int = 0) -> jnp.ndarray:
    """Batched power grids: ``[B, n_sv, n_dop, P]`` for B coherent blocks.

    All B blocks share each FFT call — the throughput configuration for
    capture scanning and non-coherent accumulation.
    """
    b, n_in = iq_blocks.shape
    nf = code_ffts_p.shape[-1]
    p = period or nf
    n_dop = dops_hz.shape[0]
    pad = (-n_dop) % dop_chunk
    dops_p = jnp.concatenate([dops_hz, jnp.zeros(pad, dops_hz.dtype)])
    chunks = dops_p.reshape(-1, dop_chunk)
    fold_fft = _fold_fft_maker(iq_blocks, fs=fs, n_coherent=n_coherent,
                               period=p, nf=nf, dop_chunk=dop_chunk)

    def per_chunk(dop_c):
        return _chunk_power(fold_fft(dop_c), code_ffts_p, p)

    pwr = jax.lax.map(per_chunk, chunks)    # [n_chunk, B, sv, chunk, P]
    pwr = jnp.moveaxis(pwr, 0, 2).reshape(
        b, code_ffts_p.shape[0], -1, p)
    return pwr[:, :, :n_dop, :]


@functools.partial(
    jax.jit,
    static_argnames=("fs", "n_coherent", "dop_chunk", "period",
                     "accumulate"))
def _corr_reduce_grid(iq_blocks: jnp.ndarray, code_ffts_p: jnp.ndarray,
                      dops_hz: jnp.ndarray, *, fs: float, n_coherent: int,
                      dop_chunk: int, period: int,
                      accumulate: bool = False):
    """Power grid reduced per Doppler chunk to ``(peak, lag, tot)``.

    Each chunk's ``[B, sv, chunk, P]`` power (:func:`_chunk_power`) is
    reduced over the P lags to its peak, first-max lag and total — the
    SNR statistic of reference: c/search_offline.cpp:190-197 — so the
    full ``[sv, n_dop, P]`` grid is never held at once.  Returns each
    ``[B, n_sv, n_dop_padded]``.  With ``accumulate=True`` the B blocks'
    powers sum non-coherently before the reduce and the leading output
    axis is 1.
    """
    nf = code_ffts_p.shape[-1]
    n_dop = dops_hz.shape[0]
    pad = (-n_dop) % dop_chunk
    dops_p = jnp.concatenate([dops_hz, jnp.zeros(pad, dops_hz.dtype)])
    chunks = dops_p.reshape(-1, dop_chunk)
    fold_fft = _fold_fft_maker(iq_blocks, fs=fs, n_coherent=n_coherent,
                               period=period, nf=nf, dop_chunk=dop_chunk)

    def per_chunk(dop_c):
        pwr = _chunk_power(fold_fft(dop_c), code_ffts_p, period)
        if accumulate:
            pwr = pwr.sum(axis=0, keepdims=True)
        return (pwr.max(axis=-1), pwr.argmax(axis=-1).astype(jnp.int32),
                pwr.sum(axis=-1))

    pk, lg, tt = jax.lax.map(per_chunk, chunks)  # [n_chunk, B', sv, chunk]
    fix = lambda a: jnp.moveaxis(a, 0, 2).reshape(
        a.shape[1], a.shape[2], -1)              # [B', sv, dop_padded]
    return fix(pk), fix(lg), fix(tt)


@functools.partial(
    jax.jit,
    static_argnames=("fs", "lo_rate", "n_coherent", "n_noncoherent",
                     "dop_chunk", "period", "from_bits"))
def acquire_refined(samples: jnp.ndarray, code_ffts_p: jnp.ndarray,
                    dops_hz: jnp.ndarray, *, fs: float, lo_rate: float,
                    n_coherent: int, n_noncoherent: int = 1,
                    dop_chunk: int = 64, from_bits: bool = False,
                    period: int = 0):
    """One-program acquisition: chunked grid reduce + on-device refine.

    :func:`_corr_reduce_grid` reduces the full (SV x Doppler) grid to
    per-SV bests; a narrow +-2-bin window around every SV's best is then
    re-correlated and parabola-refined on device (sub-bin Doppler,
    sub-sample code phase — the same arithmetic as :func:`refine_peak`).
    Returns a stacked ``[3, n_sv]`` float32 array ``(snr, doppler_hz,
    ca_shift)`` — one tiny host fetch instead of the ``[n_sv, n_dop, P]``
    grid the two-pass path fetches.

    ``n_noncoherent > 1`` sums that many consecutive coherent blocks'
    powers (for the main grid and the window alike).
    """
    iq = (mix_baseband(samples, lo_rate) if from_bits
          else samples.astype(jnp.complex64))
    block = n_coherent * period
    blocks = iq[: n_noncoherent * block].reshape(n_noncoherent, block)
    pk, _, tt = _corr_reduce_grid(
        blocks, code_ffts_p, dops_hz, fs=fs, n_coherent=n_coherent,
        dop_chunk=dop_chunk, period=period, accumulate=True)
    n_dop = dops_hz.shape[0]
    snr_grid = (pk / (tt / period))[0, :, :n_dop]      # [sv, dop]
    centers = dops_hz[snr_grid.argmax(axis=-1)]        # [sv]
    return _refine_from_centers(blocks, code_ffts_p, centers, dops_hz,
                                fs=fs, n_coherent=n_coherent,
                                period=period)


def _refine_from_centers(blocks: jnp.ndarray, code_ffts_p: jnp.ndarray,
                         centers: jnp.ndarray, dops_hz: jnp.ndarray, *,
                         fs: float, n_coherent: int,
                         period: int) -> jnp.ndarray:
    """±2-bin window re-correlation + parabolic refine around per-SV
    Doppler ``centers``; returns stacked ``[3, n_sv]`` (snr, dop, ca).

    The second half of :func:`acquire_refined`, shared with the
    mesh-sharded cold search (tpu_gnss.dist.shard.acquire_refined_sharded)
    so single-device and distributed cold starts use the identical
    refinement arithmetic.
    """
    n_dop = dops_hz.shape[0]
    n_sv, nf = code_ffts_p.shape
    step = (dops_hz[1] - dops_hz[0]) if n_dop > 1 else jnp.float32(1.0)
    offs = (jnp.arange(5, dtype=jnp.float32) - 2.0) * step
    wdops = (centers[:, None] + offs[None, :]).reshape(-1)   # [sv*5]
    fold = _fold_maker(blocks, fs=fs, n_coherent=n_coherent,
                       period=period, dop_chunk=int(wdops.shape[0]))
    f = jnp.fft.fft(fold(wdops), n=nf, axis=-1)        # [B, sv*5, NF]
    f = f.reshape(-1, n_sv, 5, nf)
    prod = code_ffts_p[None, :, None, :] * jnp.conj(f)
    lin = jnp.fft.ifft(prod, axis=-1)
    corr = (lin[..., :period] if nf == period
            else lin[..., :period] + lin[..., nf - period:])
    pwr = (corr.real ** 2 + corr.imag ** 2).sum(0)     # [sv, 5, P]

    flat = pwr.reshape(n_sv, -1).argmax(axis=-1)
    d0 = (flat // period).astype(jnp.int32)            # [sv] window row
    l0 = (flat % period).astype(jnp.int32)             # [sv] lag

    def parabola(ym, y0, yp):
        den = ym - 2.0 * y0 + yp
        return jnp.where(den < 0.0, 0.5 * (ym - yp)
                         / jnp.where(den < 0.0, den, 1.0), 0.0)

    # Doppler parabola at the peak lag (edge rows keep the bin value)
    col = jnp.take_along_axis(pwr, l0[:, None, None], axis=2)[..., 0]
    take_d = lambda di: jnp.take_along_axis(
        col, jnp.clip(d0 + di, 0, 4)[:, None], axis=1)[:, 0]
    dd = jnp.where((d0 > 0) & (d0 < 4),
                   parabola(take_d(-1), take_d(0), take_d(1)), 0.0)
    # lag parabola with code-period wraparound
    row = jnp.take_along_axis(pwr, d0[:, None, None], axis=1)[:, 0, :]
    take_l = lambda li: jnp.take_along_axis(
        row, ((l0 + li) % period)[:, None], axis=1)[:, 0]
    y0 = take_l(0)
    dl = parabola(take_l(-1), y0, take_l(1))
    snr = y0 / (row.sum(axis=-1) / period)
    dop = centers + (d0.astype(jnp.float32) - 2.0 + dd) * step
    ca = (l0.astype(jnp.float32) + dl) % period
    # one stacked output = one device->host fetch for the caller
    return jnp.stack([snr, dop, ca])


@functools.partial(
    jax.jit,
    static_argnames=("fs", "lo_rate", "n_coherent", "dop_chunk",
                     "from_bits", "period"))
def acquire_folded_batch(samples: jnp.ndarray, code_ffts_p: jnp.ndarray,
                         dops_hz: jnp.ndarray, *, fs: float, lo_rate: float,
                         n_coherent: int, dop_chunk: int = 64,
                         from_bits: bool = False,
                         period: int = 0) -> FoldedResult:
    """Batched block acquisition: ``samples [B, block_len]`` -> per-block
    FoldedResult with ``[B, n_sv]`` fields."""
    if from_bits:
        iq = mix_baseband(samples, lo_rate)
    else:
        iq = samples.astype(jnp.complex64)
    pwr = fold_power_grid_batch(iq, code_ffts_p, dops_hz, fs=fs,
                                n_coherent=n_coherent, dop_chunk=dop_chunk,
                                period=period)
    return jax.vmap(lambda g: reduce_grid(g, dops_hz))(pwr)


@functools.partial(
    jax.jit,
    static_argnames=("n_bits", "fs", "lo_rate", "n_coherent",
                     "n_noncoherent", "dop_chunk", "period"))
def acquire_folded_packed(words: jnp.ndarray, code_ffts_p: jnp.ndarray,
                          dops_hz: jnp.ndarray, *, n_bits: int, fs: float,
                          lo_rate: float, n_coherent: int,
                          n_noncoherent: int = 1, dop_chunk: int = 64,
                          period: int = 0) -> FoldedResult:
    """Acquisition straight from packed 1-bit words.

    Captures transfer host->device bit-packed (LSB-first uint32 words,
    :func:`tpu_gnss.ops.onebit.pack_bits_to_words` — 8x smaller than
    unpacked bytes) and are unpacked+mixed on device in the same program.
    """
    from ..ops import onebit
    iq = onebit.mix_packed(words, n_bits=n_bits, lo_rate=lo_rate)
    return acquire_folded(iq, code_ffts_p, dops_hz, fs=fs, lo_rate=lo_rate,
                          n_coherent=n_coherent, n_noncoherent=n_noncoherent,
                          dop_chunk=dop_chunk, from_bits=False,
                          period=period)


@jax.jit
def reduce_grid(pwr: jnp.ndarray, dops_hz: jnp.ndarray) -> FoldedResult:
    """Best (SNR, Doppler, lag) per SV from an accumulated power grid."""
    p = pwr.shape[-1]
    max_lag = pwr.argmax(axis=-1).astype(jnp.int32)       # [sv, dop]
    max_pwr = pwr.max(axis=-1)
    snr = max_pwr / (pwr.sum(axis=-1) / p)
    best = snr.argmax(axis=-1)                            # first max wins
    take = lambda a: jnp.take_along_axis(a, best[:, None], 1)[:, 0]
    return FoldedResult(take(snr), dops_hz[best],
                        take(max_lag))


@functools.partial(
    jax.jit,
    static_argnames=("fs", "lo_rate", "n_coherent", "n_noncoherent",
                     "dop_chunk", "from_bits", "period"))
def _power_grid_sum_jit(samples: jnp.ndarray, code_ffts_p: jnp.ndarray,
                        dops_hz: jnp.ndarray, *, fs: float, lo_rate: float,
                        n_coherent: int, n_noncoherent: int,
                        dop_chunk: int, from_bits: bool,
                        period: int = 0) -> jnp.ndarray:
    """Non-coherently accumulated power grid over consecutive blocks
    (the grid-valued sibling of :func:`acquire_folded`)."""
    iq = (mix_baseband(samples, lo_rate) if from_bits
          else samples.astype(jnp.complex64))
    p = period or code_ffts_p.shape[-1]
    block = n_coherent * p
    pwr = None
    for b in range(n_noncoherent):
        seg = jax.lax.dynamic_slice_in_dim(iq, b * block, block)
        g = fold_power_grid(seg, code_ffts_p, dops_hz, fs=fs,
                            n_coherent=n_coherent, dop_chunk=dop_chunk,
                            period=period)
        pwr = g if pwr is None else pwr + g
    return pwr


@functools.partial(
    jax.jit,
    static_argnames=("fs", "lo_rate", "n_coherent", "n_noncoherent",
                     "dop_chunk", "from_bits", "period"))
def acquire_folded(samples: jnp.ndarray, code_ffts_p: jnp.ndarray,
                   dops_hz: jnp.ndarray, *, fs: float, lo_rate: float,
                   n_coherent: int, n_noncoherent: int = 1,
                   dop_chunk: int = 64,
                   from_bits: bool = False,
                   period: int = 0) -> FoldedResult:
    """Fully-jitted folded acquisition: mix -> fold blocks -> reduce.

    One compiled program end-to-end (some backends cannot execute eager
    op-by-op dispatch at all); non-coherent blocks unroll statically.
    """
    pwr = _power_grid_sum_jit(samples, code_ffts_p, dops_hz, fs=fs,
                              lo_rate=lo_rate, n_coherent=n_coherent,
                              n_noncoherent=n_noncoherent,
                              dop_chunk=dop_chunk, from_bits=from_bits,
                              period=period)
    return reduce_grid(pwr, dops_hz)


def refine_peak(pwr: np.ndarray, dops_hz: np.ndarray, sv_row: int
                ) -> dict:
    """Sub-bin Doppler / sub-sample code-phase refinement by parabolic
    interpolation around the power-grid peak.

    The reference hands the tracker integer-bin estimates and lets the
    loops pull in (c/channel.cpp:144-163); refined seeds cut pull-in time
    and make the FLL capture range irrelevant.

    Args:
      pwr: ``[n_sv, n_dop, P]`` grid from :meth:`FoldedSearcher.power_grid`.
      dops_hz: matching Doppler grid.
      sv_row: SV row to refine.

    Returns dict with doppler_hz, ca_shift (float, samples), snr.
    """
    g = np.asarray(pwr[sv_row])
    n_dop, p = g.shape
    d0, l0 = np.unravel_index(np.argmax(g), g.shape)

    def parabola(ym, y0, yp):
        den = ym - 2.0 * y0 + yp
        return 0.0 if den >= 0 else 0.5 * (ym - yp) / den

    dd = 0.0
    if 0 < d0 < n_dop - 1:
        dd = parabola(g[d0 - 1, l0], g[d0, l0], g[d0 + 1, l0])
    dl = parabola(g[d0, (l0 - 1) % p], g[d0, l0], g[d0, (l0 + 1) % p])
    step = float(dops_hz[1] - dops_hz[0]) if n_dop > 1 else 0.0
    # degenerate (all-zero) grid row -> SNR 0, not a 0/0 warning (the
    # same NaN-safe stance as _dets_from_stack)
    tot = float(g[d0].sum()) / p
    snr = float(g[d0, l0] / tot) if tot > 0.0 else 0.0
    return dict(doppler_hz=float(dops_hz[d0]) + dd * step,
                ca_shift=(l0 + dl) % p, snr=snr)


class FoldedSearcher:
    """High-level folded acquisition engine.

    Args:
      cfg: receiver configuration (fs, fc, max_fo, threshold, prns).
      n_coherent: code periods per coherent fold (default 4 ≈ the
        reference's 4 ms window at 10 Msps).
      dop_spacing_hz: Doppler grid step.  Default: the reference bin
        ``cfg.dop_bin_hz`` (fs/fft_len), capped at one bin of the
        COHERENT FOLD length, ``1000/n_coherent`` Hz.  The per-bin
        wipe-off is exact, so the only Doppler loss is grid
        quantization: a residual of f_r Hz rotates the n per-period
        phasors by 2*pi*f_r/1000 each, attenuating the fold by
        |sin(n*phi/2)/(n*sin(phi/2))|.  Without the cap, a config whose
        fft_len/fs window is SHORTER than the fold (e.g. fft 4096 at
        2.048 Msps: 500 Hz bins, 4 ms fold) hits a complete NULL at
        half-bin residuals (250 Hz -> phasors at 90 deg steps sum to
        zero).  The cap bounds the worst case at ~-3.9 dB — the same
        scalloping class the reference's own window accepts
        (c/search_offline.cpp:169-201's bins are 1/T_window).  Pass
        ``500/n_coherent`` for a -0.9 dB bound at 2x the grid.
    """

    def __init__(self, cfg: ReceiverConfig, n_coherent: int = 4,
                 dop_spacing_hz: Optional[float] = None,
                 dop_chunk: int = 64):
        self.cfg = cfg
        self.n_coherent = n_coherent
        self.period = int(cfg.fs / 1000)
        self.block_len = self.period * n_coherent
        self.nf = fft_len_for_period(self.period)
        if dop_spacing_hz is None:
            dop_spacing_hz = min(cfg.dop_bin_hz, 1000.0 / n_coherent)
        self.dops_hz = jnp.asarray(doppler_grid_hz(cfg, dop_spacing_hz))
        self.dop_chunk = min(dop_chunk, len(self.dops_hz))

    @property
    def code_ffts_p(self):
        """Device replica spectra, built LAZILY on first use.

        The FFT compile + upload then happens in the receiver's prewarm
        thread, overlapped with first-chunk I/O, instead of inside the
        Receiver constructor on the cold-TTFF critical path.  Shared across instances
        (_code_ffts_device is keyed on (fs, prns, nf)).
        """
        return _code_ffts_device(self.cfg.fs, tuple(self.cfg.prns),
                                 self.nf)

    # ------------------------------------------------------------------
    def _prep(self, bits, iq, n_noncoherent: int):
        """Validate input length; return (samples, from_bits)."""
        need = n_noncoherent * self.block_len
        if bits is not None:
            samples = jnp.asarray(bits, dtype=jnp.uint8)
            from_bits = True
        elif isinstance(iq, np.ndarray):
            from ..utils.xfer import to_device_complex
            samples, from_bits = to_device_complex(iq), False
        else:
            samples, from_bits = iq, False
        if samples.shape[-1] < need:
            raise ValueError(
                f"need {need} samples ({n_noncoherent} x {self.n_coherent} "
                f"periods of {self.period}), got {samples.shape[-1]}")
        return samples, from_bits

    def power_grid(self, bits=None, iq=None,
                   n_noncoherent: int = 1) -> jnp.ndarray:
        """[n_sv, n_dop, P] power grid for one coherent block.

        ``n_noncoherent > 1`` sums that many consecutive blocks' grids
        (weak-signal accumulation, SURVEY §5)."""
        samples, from_bits = self._prep(bits, iq, n_noncoherent)
        return _power_grid_sum_jit(samples, self.code_ffts_p, self.dops_hz,
                                   fs=self.cfg.fs, lo_rate=self.cfg.lo_rate,
                                   n_coherent=self.n_coherent,
                                   n_noncoherent=n_noncoherent,
                                   dop_chunk=self.dop_chunk,
                                   from_bits=from_bits, period=self.period)

    def acquire_packed(self, words_or_bits,
                       n_noncoherent: int = 1) -> FoldedResult:
        """Acquire from bit-packed input (host bits or packed words).

        Host {0,1} bit arrays are packed here (``pack_bits_to_words``);
        the device sees 1/8 the transfer volume of the uint8 path.
        """
        from ..ops import onebit
        x = np.asarray(words_or_bits)
        if x.dtype != np.uint32:  # raw bits -> pack
            x = onebit.pack_bits_to_words(x)
        need = n_noncoherent * self.block_len
        if x.shape[0] * 32 < need:
            raise ValueError(f"need {need} samples, got {x.shape[0] * 32}")
        return acquire_folded_packed(
            jnp.asarray(x), self.code_ffts_p, self.dops_hz, n_bits=need,
            fs=self.cfg.fs, lo_rate=self.cfg.lo_rate,
            n_coherent=self.n_coherent, n_noncoherent=n_noncoherent,
            dop_chunk=self.dop_chunk, period=self.period)

    def acquire(self, bits=None, iq=None,
                n_noncoherent: int = 1) -> FoldedResult:
        """Search one capture segment; optional non-coherent accumulation.

        With ``n_noncoherent > 1``, consecutive coherent blocks' power
        grids are summed before the peak search (weak-signal mode).
        """
        samples, from_bits = self._prep(bits, iq, n_noncoherent)
        return acquire_folded(samples, self.code_ffts_p, self.dops_hz,
                              fs=self.cfg.fs, lo_rate=self.cfg.lo_rate,
                              n_coherent=self.n_coherent,
                              n_noncoherent=n_noncoherent,
                              dop_chunk=self.dop_chunk,
                              from_bits=from_bits, period=self.period)

    def detections_refined_fast(self, bits=None, iq=None,
                                n_noncoherent: int = 1,
                                skip_prns=()) -> list[dict]:
        """Grid detection + exact narrow-window refinement, one program.

        The grid is reduced per Doppler chunk to per-SV bests, and a
        ±2-bin window around every SV's best is re-correlated and
        parabola-refined on device in the same jitted program
        (:func:`acquire_refined`) — ONE tiny ``[3, n_sv]`` host fetch
        instead of the full ``[n_sv, n_dop, P]`` float grid.

        ``n_noncoherent > 1`` sums that many consecutive coherent
        blocks' powers before the peak search (and sums the refinement
        window grids likewise) — the weak-signal escalation (SURVEY §5:
        non-coherent integration across blocks).

        ``skip_prns``: PRNs filtered out of the result (already tracked).
        """
        samples, from_bits = self._prep(bits, iq, n_noncoherent)
        # routed through the exported-program cache: a fresh process
        # skips this program's trace (utils.progcache; identical math)
        from ..utils import progcache
        stacked = progcache.call(
            "acq_refined", acquire_refined,
            args=(samples, self.code_ffts_p, self.dops_hz),
            static_kwargs=dict(
                fs=self.cfg.fs, lo_rate=self.cfg.lo_rate,
                n_coherent=self.n_coherent, n_noncoherent=n_noncoherent,
                dop_chunk=self.dop_chunk, from_bits=from_bits,
                period=self.period))
        return self._dets_from_stack(stacked, skip_prns, n_noncoherent)

    def detections_refined_sharded(self, bits=None, iq=None,
                                   n_noncoherent: int = 1,
                                   skip_prns=(), mesh=None) -> list[dict]:
        """Mesh-sharded cold search, same decisions as the fast path.

        The chunked grid reduce is Doppler-sharded over
        ``mesh['dop']`` and the refinement arithmetic is shared with
        :meth:`detections_refined_fast`
        (tpu_gnss.dist.shard.acquire_refined_sharded) — the distributed
        receiver's cold/re-acquisition engine (the reference's whole
        search task on one processor, c/main.cpp:66, spread over the
        mesh instead).
        """
        from ..dist.shard import acquire_refined_sharded, pad_dops
        samples, from_bits = self._prep(bits, iq, n_noncoherent)
        # the padded grid is mesh-shape-dependent and re-used every
        # cold/re-acquisition search — build + upload it once
        pad_key = (mesh.shape["dop"], self.dop_chunk)
        cached = getattr(self, "_dops_pad", None)
        if cached is None or cached[0] != pad_key:
            dops_pad = jnp.asarray(pad_dops(np.asarray(self.dops_hz),
                                            *pad_key))
            self._dops_pad = cached = (pad_key, dops_pad)
        dops_pad = cached[1]
        stacked = acquire_refined_sharded(
            samples, self.code_ffts_p, dops_pad, mesh=mesh,
            fs=self.cfg.fs, lo_rate=self.cfg.lo_rate,
            n_coherent=self.n_coherent, n_noncoherent=n_noncoherent,
            dop_chunk=self.dop_chunk, period=self.period,
            from_bits=from_bits)
        return self._dets_from_stack(stacked, skip_prns, n_noncoherent)

    def _dets_from_stack(self, stacked, skip_prns=(),
                         n_noncoherent: int = 1) -> list[dict]:
        """Threshold a ``[3, n_sv]`` (snr, dop, ca) device stack."""
        thr = noncoherent_threshold(self.cfg.snr_threshold, n_noncoherent)
        snr, dop, ca = np.asarray(stacked)
        # near-far reference: strongest over ALL PRNs (a tracked-and-
        # skipped strong SV still pollutes the others' cross floor).
        # A degenerate head (all-zero input) makes every SNR NaN; the
        # guard reference is then 0 — no warning-throwing all-NaN
        # nanmax, and the NaN-safe threshold below rejects every row.
        finite = snr[np.isfinite(snr)]
        smax = float(finite.max()) if finite.size else 0.0
        out = []
        for i, prn in enumerate(self.cfg.prns):
            # NaN-safe inclusion test: a degenerate (e.g. all-zero) head
            # yields NaN SNRs, which must not pass the threshold
            if prn in skip_prns or not (snr[i] >= thr):
                continue
            if not _near_far_ok(float(snr[i]), smax, n_noncoherent):
                continue
            out.append(dict(prn=prn, sv=prn - 1, snr=float(snr[i]),
                            doppler_hz=float(dop[i]),
                            ca_shift=float(ca[i]),
                            lo_shift=int(round(float(dop[i])
                                               / self.cfg.dop_bin_hz))))
        return out

    def detections_refined(self, pwr,
                           n_noncoherent: int = 1) -> list[dict]:
        """Threshold + sub-bin refine straight from a power grid.

        One host fetch of the ``[n_sv, n_dop, P]`` float grid buys
        parabolic-refined Doppler/code-phase seeds for every detection.
        ``n_noncoherent``: how many blocks the grid accumulates — the
        threshold is false-alarm-equalized (noncoherent_threshold).
        """
        thr = noncoherent_threshold(self.cfg.snr_threshold, n_noncoherent)
        pwr = np.asarray(pwr)
        dops = np.asarray(self.dops_hz)
        refs = [refine_peak(pwr, dops, i)
                for i in range(len(self.cfg.prns))]
        smax = max((r["snr"] for r in refs), default=0.0)
        out = []
        for prn, ref in zip(self.cfg.prns, refs):
            if ref["snr"] < thr:
                continue
            if not _near_far_ok(ref["snr"], smax, n_noncoherent):
                continue
            out.append(dict(prn=prn, sv=prn - 1, snr=ref["snr"],
                            doppler_hz=ref["doppler_hz"],
                            ca_shift=ref["ca_shift"],
                            lo_shift=int(round(ref["doppler_hz"]
                                               / self.cfg.dop_bin_hz))))
        return out

    def detections(self, res: FoldedResult,
                   n_noncoherent: int = 1) -> list[dict]:
        thr = noncoherent_threshold(self.cfg.snr_threshold, n_noncoherent)
        snr = np.asarray(res.snr)
        dop = np.asarray(res.doppler_hz)
        ca = np.asarray(res.ca_shift)
        finite = snr[np.isfinite(snr)]
        smax = float(finite.max()) if finite.size else 0.0
        out = []
        for i, prn in enumerate(self.cfg.prns):
            if (snr[i] >= thr
                    and _near_far_ok(float(snr[i]), smax, n_noncoherent)):
                out.append(dict(
                    prn=prn, sv=prn - 1, snr=float(snr[i]),
                    doppler_hz=float(dop[i]), ca_shift=int(ca[i]),
                    lo_shift=int(round(float(dop[i]) / self.cfg.dop_bin_hz))))
        return out
