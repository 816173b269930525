"""Vectorized tracking channel bank — DLL + Costas loops as a lax.scan.

The reference tracks 12 satellites in FPGA fabric: per-channel code/carrier
NCOs, early/prompt/late correlators with 1 ms integrate-and-dump, and PI
loop filters serviced at the epoch rate, supervised over SPI
(reference: c/channel.cpp; loop structure documented in
"Homemade GPS Receiver.html":287-352 — ~20 Hz Costas, ~1 Hz DLL).

Here the whole channel bank is one array program: state is a pytree batched
over channels, each 1 ms epoch processes a fixed ``P = fs/1000``-sample
block shared by all channels (they all see the same front-end stream, so
the correlators are one broadcasted multiply-reduce), and time is a
``lax.scan`` over epochs.  Fixed-size blocks keep shapes static for XLA;
code-phase drift relative to the block grid lives in the fractional
``code_phase`` state instead of variable block lengths.

Loop design: standard 2nd-order loops (Kaplan/Hegarty coefficients,
zeta = 0.707) with NCO frequency = seed + filter(e), where the seed comes
from acquisition and the filter is proportional + accumulated integral.
The reference's carrier pull-in trick — re-seeding the carrier NCO from
the locked code Doppler after a settling period
(reference: c/channel.cpp:190-207) — is :func:`carrier_pull_in`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import CHIP_RATE_HZ, CODE_LEN_CHIPS, L1_HZ
from ..signal import cacode


def second_order_gains(bn_hz: float, zeta: float = 0.7071,
                       t_s: float = 1e-3) -> tuple[float, float]:
    """(k1, k2) for a 2nd-order loop updated every ``t_s`` seconds.

    wn = 8*zeta*Bn/(4*zeta^2+1); filter(e) = k1*e + acc, acc += k2*e.
    """
    wn = 8.0 * zeta * bn_hz / (4.0 * zeta * zeta + 1.0)
    return 2.0 * zeta * wn, wn * wn * t_s


class ChannelState(NamedTuple):
    """Batched tracking state, all arrays ``[n_chan]``."""
    active: jnp.ndarray         # bool: channel enabled
    carrier_phase: jnp.ndarray  # cycles, mod 1
    carrier_seed: jnp.ndarray   # Hz: acquisition / pull-in Doppler seed
    code_phase: jnp.ndarray     # chips, mod 1023
    pll_acc: jnp.ndarray        # PLL integrator (rad/s)
    dll_acc: jnp.ndarray        # DLL integrator (chips/s)
    carrier_freq: jnp.ndarray   # Hz: last effective carrier frequency
    code_dev: jnp.ndarray       # chips/s: code-rate DEVIATION from
                                # CHIP_RATE_HZ (small -> float32-precise;
                                # absolute rate = CHIP_RATE_HZ + code_dev)
    pwr_avg: jnp.ndarray        # running prompt power average
    ip_prev: jnp.ndarray        # previous prompt I (FLL discriminator)
    qp_prev: jnp.ndarray        # previous prompt Q
    agc_on: jnp.ndarray         # bool: strong-signal gain reduction active


class EpochOut(NamedTuple):
    """Per-epoch outputs, arrays ``[n_epochs, n_chan]``."""
    ip: jnp.ndarray
    qp: jnp.ndarray
    e_mag: jnp.ndarray
    l_mag: jnp.ndarray
    carrier_freq: jnp.ndarray
    code_dev: jnp.ndarray       # chips/s deviation from CHIP_RATE_HZ
    code_phase: jnp.ndarray     # chips at epoch START


# jax.export needs named (de)serialization for custom pytree nodes so
# the tracker program can ride the exported-program cache
# (utils.progcache); no-op on jax versions without the registry.
try:
    jax.export.register_namedtuple_serialization(
        ChannelState, serialized_name="tpu_gnss.track.ChannelState")
    jax.export.register_namedtuple_serialization(
        EpochOut, serialized_name="tpu_gnss.track.EpochOut")
except Exception:
    pass


def init_state(n_chan: int) -> ChannelState:
    z = jnp.zeros(n_chan, jnp.float32)
    return ChannelState(
        active=jnp.zeros(n_chan, bool),
        carrier_phase=z, carrier_seed=z, code_phase=z,
        pll_acc=z, dll_acc=z,
        carrier_freq=z,
        code_dev=jnp.zeros(n_chan, jnp.float32),
        pwr_avg=z, ip_prev=z, qp_prev=z,
        agc_on=jnp.zeros(n_chan, bool))


def start_channel(state: ChannelState, ch: int, doppler_hz: float,
                  code_phase_chips: float,
                  code_doppler_hz: Optional[float] = None) -> ChannelState:
    """Seed one channel from an acquisition result.

    ``code_phase_chips``: code phase (advance) at the first sample the
    tracker will see — from acquisition, ``ca_shift * CHIP_RATE/fs`` plus
    whole-block drift.  Doppler-scaled code rate seeding mirrors the
    reference's channel start (reference: c/channel.cpp:144-149).

    ``code_doppler_hz``: the MOTION part of the detected Doppler, used
    for the code-rate seed.  Defaults to ``doppler_hz``; pass
    ``doppler_hz - if_offset`` for replay captures where a common TX/RX
    oscillator offset (tens of kHz, reference README.md §2.1e) shifts
    the carrier without scaling the code rate — seeding the code NCO
    from the raw detected Doppler would then miss by
    ``offset * CHIP_RATE/L1`` chips/s (~32 chips/s at 50 kHz), far
    outside the DLL's pull-in.
    """
    if code_doppler_hz is None:
        code_doppler_hz = doppler_hz
    upd = lambda a, v: a.at[ch].set(jnp.float32(v))
    return state._replace(
        active=state.active.at[ch].set(True),
        carrier_phase=upd(state.carrier_phase, 0.0),
        carrier_seed=upd(state.carrier_seed, doppler_hz),
        code_phase=upd(state.code_phase, code_phase_chips % CODE_LEN_CHIPS),
        pll_acc=upd(state.pll_acc, 0.0),
        dll_acc=upd(state.dll_acc, 0.0),
        carrier_freq=upd(state.carrier_freq, doppler_hz),
        code_dev=upd(state.code_dev,
                     CHIP_RATE_HZ * code_doppler_hz / L1_HZ),
        pwr_avg=upd(state.pwr_avg, 0.0),
        ip_prev=upd(state.ip_prev, 0.0),
        qp_prev=upd(state.qp_prev, 0.0),
        agc_on=state.agc_on.at[ch].set(False))


@jax.jit
def _start_channels_jit(state: ChannelState, seeds: jnp.ndarray
                        ) -> ChannelState:
    chs = seeds[0].astype(jnp.int32)    # exact for any realistic bank
    dop, cp, cdev = seeds[1], seeds[2], seeds[3]
    upd = lambda a, v: a.at[chs].set(v)
    z = jnp.zeros_like(dop)
    return state._replace(
        active=state.active.at[chs].set(True),
        carrier_phase=upd(state.carrier_phase, z),
        carrier_seed=upd(state.carrier_seed, dop),
        code_phase=upd(state.code_phase, cp),
        pll_acc=upd(state.pll_acc, z),
        dll_acc=upd(state.dll_acc, z),
        carrier_freq=upd(state.carrier_freq, dop),
        code_dev=upd(state.code_dev, cdev),
        pwr_avg=upd(state.pwr_avg, z),
        ip_prev=upd(state.ip_prev, z),
        qp_prev=upd(state.qp_prev, z),
        agc_on=state.agc_on.at[chs].set(False))


def start_channels(state: ChannelState, chs, doppler_hz,
                   code_phase_chips, code_doppler_hz) -> ChannelState:
    """Batched :func:`start_channel`: ONE jitted dispatch for any number
    of seeds (the per-channel eager version is ~13 device dispatches per
    channel, on the cold time-to-first-fix path).  Host inputs are padded to the
    bank width so a single compiled program serves every start count
    (padded entries repeat row 0 with identical values, so the
    duplicate scatter is deterministic), and packed into ONE ``[4, n]``
    float32 upload so the seeding costs a single link transfer.
    """
    n = int(state.active.shape[0])
    k = len(chs)
    assert 1 <= k <= n
    seeds = np.empty((4, k), np.float32)
    seeds[0] = np.asarray(chs, np.float32)
    seeds[1] = np.asarray(doppler_hz, np.float32)
    seeds[2] = (np.asarray(code_phase_chips, np.float64)
                % CODE_LEN_CHIPS).astype(np.float32)
    seeds[3] = (CHIP_RATE_HZ * np.asarray(code_doppler_hz, np.float64)
                / L1_HZ).astype(np.float32)
    if k < n:
        seeds = np.concatenate(
            [seeds, np.repeat(seeds[:, :1], n - k, axis=1)], axis=1)
    return _start_channels_jit(state, seeds)


@functools.partial(
    jax.jit,
    static_argnames=("fs", "pll_gains", "dll_gains", "fll_bn_hz",
                     "corr_spacing", "carrier_aiding", "epochs_per_step",
                     "agc_thresholds"))
def track_epochs(samples: jnp.ndarray, state: ChannelState,
                 code_tables: jnp.ndarray, *, fs: float,
                 pll_gains: tuple[float, float],
                 dll_gains: tuple[float, float],
                 fll_bn_hz: float = 3.0,
                 corr_spacing: float = 0.5,
                 carrier_aiding: bool = True,
                 epochs_per_step: int = 1,
                 code_ffts: Optional[jnp.ndarray] = None,
                 agc_thresholds: Optional[tuple[float, float]] = None,
                 aid_offset_hz=0.0
                 ) -> tuple[ChannelState, EpochOut]:
    """Run the channel bank over a span of complex baseband samples.

    Args:
      samples: ``[n_epochs * P]`` complex64 baseband (front-end mixed);
        length is truncated to a whole number of steps.
      state: batched ChannelState.
      code_tables: ``[n_chan, 1023]`` bipolar float32 chips per channel.
      fs: sample rate; P = round(fs/1000) samples per epoch.
      pll_gains / dll_gains: (k1, k2) from :func:`second_order_gains`
        called with ``t_s = epochs_per_step * 1e-3``.
      corr_spacing: early/late offset in chips.
      carrier_aiding: derive code-rate Doppler from the carrier loop
        (scaled by CHIP_RATE/L1), the standard aiding the reference
        approximates with its pull-in reseeding.
      epochs_per_step: correlate this many 1 ms epochs per loop update
        (discriminators average over them).  Correlator outputs stay
        per-epoch, so NAV decode is unaffected; the loop update rate
        drops to 1000/epochs_per_step Hz.  Measured tolerance (swept in
        tests/test_track.py::test_doppler_ramp_tolerance): because the
        gains scale with t_s, the 100/200/500 Hz update rates realize
        the same continuous-time loop and all hold lock through carrier
        ramps >= 120 Hz/s — ~25x any ground-static sky dynamics — with
        only the deterministic 2nd-order ramp lag (~2*pi*ramp/wn^2 rad
        of phase).  The practical bound is update rate >= ~5x the PLL
        bandwidth (the default 100 Hz / 18 Hz = 5.5x is fine); below
        that the discrete loop loses phase margin.  Values > 1 amortize
        the sequential per-step overhead of the scan.
      agc_thresholds: optional ``(lo, hi)`` on the running prompt power
        average ``pwr_avg``.  When the average rises above ``hi`` the
        Costas discriminator gain is halved until it falls back below
        ``lo`` — the reference's strong-signal AGC with hysteresis
        (reference: c/channel.cpp:265-288, thresholds 1200^2/1400^2 in
        its fixed-point scale).  ``None`` disables the AGC.
      aid_offset_hz: carrier frequency NOT attributable to motion (a
        common TX/RX oscillator offset on replay captures), subtracted
        before the carrier-aiding scale to CHIP_RATE/L1.  Traced scalar
        — changing the value does not retrace.
      code_ffts: ``[n_chan, NF]`` spectra from :func:`code_spectra`.
        Given, the correlators are FFT-dot taps (gather-free); ``None``
        selects the reference-style resampled-code gather correlators.

    Returns (final state, per-epoch outputs).
    """
    p = int(round(fs * 1e-3))
    e_sub = epochs_per_step
    step_len = p * e_sub
    n_steps = samples.shape[0] // step_len
    blocks = samples[: n_steps * step_len].reshape(n_steps, e_sub, p)
    pll_k1, pll_k2 = pll_gains
    dll_k1, dll_k2 = dll_gains
    # sample index within a step: [e_sub, P]
    n = (jnp.arange(e_sub, dtype=jnp.float32)[:, None] * p
         + jnp.arange(p, dtype=jnp.float32)[None, :])
    two_pi = 2.0 * jnp.pi
    t_epoch = step_len / fs  # loop update interval

    e_steps = jnp.arange(e_sub, dtype=jnp.float32)[None, :] * p
    e_idx = jnp.arange(e_sub, dtype=jnp.float32)[None, :]

    # Code-NCO precision: the phase advance per step is ~1023 * e_sub
    # chips; adding it to the phase in float32 rounds at an ulp of
    # ~1e-3 chips (~0.3 m) per 10 ms step, and the quasi-constant
    # fractional advance makes the rounding BIASED — the DLL absorbs it
    # (the device phase stays locked to the signal) but any host-side
    # integral of the commanded code rate then drifts from the true code
    # phase by tens of m/s (observed: ~-23 m/s common-mode, ~±2 m/s
    # differential => fix error growing ~1.5 m/s on the 20 s e2e scene).
    # Hence (a) the state carries the code-rate DEVIATION ``code_dev``
    # (absolute float32 rate near 1.023e6 would quantize DLL commands to
    # 0.0625 chips/s ~ 18 m/s), and (b) the phase advances by that
    # deviation plus the nominal advance reduced mod 1023 in float64
    # here on the host (exactly 0 for the integer-kHz sample rates of
    # every capture preset) — intermediate sums stay ~1 code period,
    # ulp ~6e-5 chips (2 cm).
    nom_step_mod = float((CHIP_RATE_HZ * step_len / fs) % CODE_LEN_CHIPS)
    nom_epoch_mod = float((CHIP_RATE_HZ * p / fs) % CODE_LEN_CHIPS)
    if code_ffts is None:
        # gather path needs the per-sample nominal chip index, reduced
        # mod 1023 in float64 before the float32 cast
        n_np = (np.arange(e_sub, dtype=np.float64)[:, None] * p
                + np.arange(p, dtype=np.float64)[None, :])
        nom_n = jnp.asarray(((CHIP_RATE_HZ / fs) * n_np) % CODE_LEN_CHIPS,
                            dtype=jnp.float32)

    # factored carrier-wipe phasor: sample index n = K*b + a splits the
    # linear phase into two short trig tables per channel (K + len/K
    # evaluations instead of e_sub*P transcendentals), matching the
    # acquisition prologue's e_m trick
    wipe_k = 256
    wipe_nb = -(-step_len // wipe_k)
    wipe_a = jnp.arange(wipe_k, dtype=jnp.float32)
    wipe_b = jnp.arange(wipe_nb, dtype=jnp.float32) * wipe_k

    def epoch(st: ChannelState, blk: jnp.ndarray):
        def wipe():
            delta = (st.carrier_freq / fs)[:, None]   # cycles/sample
            pha = (-two_pi) * ((delta * wipe_a[None, :]) % 1.0)
            phb = (-two_pi) * ((st.carrier_phase[:, None]
                                + delta * wipe_b[None, :]) % 1.0)
            ea = jax.lax.complex(jnp.cos(pha), jnp.sin(pha))  # [n_chan, K]
            eb = jax.lax.complex(jnp.cos(phb), jnp.sin(phb))  # [n_chan, nb]
            lo = (eb[:, :, None] * ea[:, None, :]).reshape(
                -1, wipe_nb * wipe_k)[:, :step_len]
            return (blk.reshape(-1)[None, :] * lo).reshape(
                lo.shape[0], e_sub, p)

        if code_ffts is not None:
            # --- FFT-dot correlators: gather-free ------------------------
            # corr(τ) = (1/NF) Σ_k W[k]·spec[k]·e^{-j2πkτ/NF}, spec from
            # code_spectra() (conj code FFT with the circular wrap folded
            # in).  Taps at fractional sample lags — no per-sample code
            # gather.  The forward transform runs as the four-step DFT
            # factored into two complex einsum matmuls, trimmed to the
            # zero-padded block's nonzero rows.  HIGHEST precision: a
            # complex64 product may otherwise run in TF32 on the GPU
            # (~3 decimal digits); the loops and fixes were validated
            # at full float32.
            wiped = wipe()
            nf = code_ffts.shape[-1]
            n1f, n2f, u_rf, f2c, wtc, f1c = _dft_tables_np(nf, p)
            cplx = lambda a: jax.lax.complex(jnp.asarray(a.real),
                                             jnp.asarray(a.imag))
            y = jnp.pad(wiped, ((0, 0), (0, 0), (0, u_rf * n1f - p))
                        ).reshape(wiped.shape[0], e_sub, u_rf, n1f)
            hi = jax.lax.Precision.HIGHEST
            z = jnp.einsum("ku,ceuv->cekv", cplx(f2c), y, precision=hi)
            g = jnp.einsum("cekv,vj->cekj", z * cplx(wtc)[None, None],
                           cplx(f1c), precision=hi)
            f_w = jnp.transpose(g, (0, 1, 3, 2)).reshape(
                wiped.shape[0], e_sub, nf)            # [n_chan, e_sub, NF]
            prod = f_w * code_ffts[:, None, :]
            chips0 = (st.code_phase[:, None]
                      + (st.code_dev / fs)[:, None]
                      * e_steps + nom_epoch_mod * e_idx)
            # one shared prompt ramp; early/late taps are the SAME ramp
            # times a fixed vector t(±δ) (exact: ramp(τ+δ) = ramp(τ)·t(δ)
            # with matching signed-frequency convention), with a per-row
            # select between t(δ) and t(δ∓P) at code-period wraps.
            scale = p / CODE_LEN_CHIPS
            s0p = (chips0 % CODE_LEN_CHIPS) * scale
            ramp = _frac_ramp(s0p.reshape(-1), nf).reshape(
                s0p.shape[0], s0p.shape[1], nf)
            w = prod * ramp
            dsamp = corr_spacing * scale
            te1, te2, tl1, tl2 = (
                jax.lax.complex(jnp.asarray(t.real), jnp.asarray(t.imag))
                for t in _tap_vectors_np(nf, dsamp, p))
            s0e = ((chips0 + corr_spacing) % CODE_LEN_CHIPS) * scale
            s0l = ((chips0 - corr_spacing) % CODE_LEN_CHIPS) * scale
            wrap_e = (s0e < s0p)[:, :, None]
            wrap_l = (s0l > s0p)[:, :, None]

            taps = {0.0: None,
                    corr_spacing: (wrap_e, te1, te2),
                    -corr_spacing: (wrap_l, tl1, tl2)}

            def corr(offset):
                sel = taps[offset]
                if sel is None:
                    return w.sum(axis=-1) / nf
                wrapped, t1, t2 = sel
                tv = jnp.where(wrapped, t2[None, None, :], t1[None, None, :])
                return (w * tv).sum(axis=-1) / nf
        else:
            # --- reference-style resampled-code correlators --------------
            wiped = wipe()
            chips_t = (st.code_phase[:, None, None]
                       + (st.code_dev / fs)[:, None, None]
                       * n[None, :, :] + nom_n[None, :, :])
            ch_idx = jnp.arange(code_tables.shape[0])[:, None, None]

            def corr(offset):
                idx = (jnp.floor(chips_t + offset).astype(jnp.int32)
                       % CODE_LEN_CHIPS)
                code = code_tables[ch_idx, idx]       # [n_chan, e_sub, P]
                return (wiped * code).sum(axis=-1)    # [n_chan, e_sub]

        cp = corr(0.0)
        ce = corr(corr_spacing)
        cl = corr(-corr_spacing)
        ip_all, qp_all = cp.real, cp.imag             # [n_chan, e_sub]
        e_mag_all = jnp.abs(ce)
        l_mag_all = jnp.abs(cl)
        # last epoch feeds the FLL memory; discriminators average epochs
        ip, qp = ip_all[:, -1], qp_all[:, -1]
        e_mag, l_mag = e_mag_all.mean(1), l_mag_all.mean(1)

        # --- discriminators (averaged over the step's epochs) ------------
        # Costas: atan(Q/I), data-bit insensitive (rad)
        pll_err = jnp.arctan(
            qp_all / jnp.where(jnp.abs(ip_all) < 1e-9, 1e-9, ip_all)
        ).mean(axis=1)
        # FLL: cross/dot over consecutive 1 ms prompts (incl. the pair
        # spanning the step boundary via the stored previous prompt)
        ipp = jnp.concatenate([st.ip_prev[:, None], ip_all], axis=1)
        qpp = jnp.concatenate([st.qp_prev[:, None], qp_all], axis=1)
        cross = ipp[:, :-1] * qp_all - qpp[:, :-1] * ip_all
        dot = ipp[:, :-1] * ip_all + qpp[:, :-1] * qp_all
        fll_pairs = jnp.arctan(
            cross / jnp.where(jnp.abs(dot) < 1e-9, 1e-9, dot)
        ) / (two_pi * 1e-3)                         # pairs are 1 ms apart
        prev_pwr = ipp[:, :-1] ** 2 + qpp[:, :-1] ** 2
        valid = (prev_pwr > 0).astype(jnp.float32)
        fll_err = (fll_pairs * valid).sum(1) / jnp.maximum(valid.sum(1), 1.0)
        # DLL: normalized noncoherent early-minus-late (chips)
        denom = jnp.maximum(e_mag + l_mag, 1e-9)
        dll_err = corr_spacing * (e_mag - l_mag) / denom

        # --- loop filters: freq = seed + k1*e + acc ----------------------
        # strong-signal AGC: halved Costas gain while agc_on (decision is
        # one step delayed, matching the reference's 4 Hz CheckPower poll)
        if agc_thresholds is not None:
            pll_err = pll_err * jnp.where(st.agc_on, 0.5, 1.0)
        # FLL assist folds straight into the PLL integrator (rad/s)
        fll_k = 4.0 * fll_bn_hz * t_epoch
        pll_acc = st.pll_acc + jnp.where(
            st.active, pll_k2 * pll_err + fll_k * two_pi * fll_err, 0.0)
        carrier_freq = jnp.where(
            st.active,
            st.carrier_seed + (pll_k1 * pll_err + pll_acc) / two_pi,
            st.carrier_freq)

        dll_acc = st.dll_acc + jnp.where(st.active, dll_k2 * dll_err, 0.0)
        # aiding uses the MOTION Doppler: a common oscillator offset
        # (replay captures, reference README.md §2.1e) sits on the
        # carrier but not the code rate — ``aid_offset_hz`` removes it
        aid = jnp.where(jnp.bool_(carrier_aiding),
                        (carrier_freq - aid_offset_hz)
                        / L1_HZ * CHIP_RATE_HZ, 0.0)
        code_dev = jnp.where(
            st.active,
            aid + dll_k1 * dll_err + dll_acc,
            st.code_dev)

        # --- NCO phase advance -------------------------------------------
        carrier_phase = jnp.where(
            st.active,
            (st.carrier_phase + carrier_freq / fs * step_len) % 1.0,
            st.carrier_phase)
        code_phase = jnp.where(
            st.active,
            (st.code_phase + code_dev / fs * step_len
             + nom_step_mod) % CODE_LEN_CHIPS,
            st.code_phase)

        pwr = (ip_all * ip_all + qp_all * qp_all).mean(axis=1)
        pwr_avg = jnp.where(st.active,
                            0.875 * st.pwr_avg + 0.125 * pwr, st.pwr_avg)
        if agc_thresholds is not None:
            agc_lo, agc_hi = agc_thresholds
            agc_on = jnp.where(
                st.active,
                jnp.where(pwr_avg > agc_hi, True,
                          jnp.where(pwr_avg < agc_lo, False, st.agc_on)),
                st.agc_on)
        else:
            agc_on = st.agc_on

        # per-epoch outputs [n_chan, e_sub]
        bcast = lambda a: jnp.broadcast_to(a[:, None], ip_all.shape)
        phase_per_epoch = (st.code_phase[:, None]
                           + (code_dev / fs)[:, None]
                           * e_steps + nom_epoch_mod * e_idx
                           ) % CODE_LEN_CHIPS
        out = EpochOut(ip=ip_all, qp=qp_all, e_mag=e_mag_all,
                       l_mag=l_mag_all,
                       carrier_freq=bcast(carrier_freq),
                       code_dev=bcast(code_dev),
                       code_phase=phase_per_epoch)
        new = ChannelState(active=st.active, carrier_phase=carrier_phase,
                           carrier_seed=st.carrier_seed,
                           code_phase=code_phase, pll_acc=pll_acc,
                           dll_acc=dll_acc, carrier_freq=carrier_freq,
                           code_dev=code_dev, pwr_avg=pwr_avg,
                           ip_prev=jnp.where(st.active, ip, st.ip_prev),
                           qp_prev=jnp.where(st.active, qp, st.qp_prev),
                           agc_on=agc_on)
        return new, out

    final, outs = jax.lax.scan(epoch, state, blocks)
    # [n_steps, n_chan, e_sub] -> [n_steps * e_sub, n_chan]
    flat = jax.tree.map(
        lambda a: jnp.moveaxis(a, 2, 1).reshape(-1, a.shape[1]), outs)
    return final, flat


def split_nf(nf: int) -> tuple[int, int]:
    """Factor NF = n1 * n2 for the four-step transform.

    Prefers n2 = 128; falls back to a near-square factorization.  Raises
    if NF has no factor pair (a prime NF).
    """
    if nf % 128 == 0:
        return nf // 128, 128
    r = int(np.sqrt(nf))
    while r > 1:
        if nf % r == 0:
            return nf // r, r
        r -= 1
    raise ValueError(f"NF={nf} has no usable factorization")


@functools.lru_cache(maxsize=8)
def _dft_tables_np(nf: int, period: int):
    """Four-step forward-DFT tables for the einsum path:
    ``(n1, n2, u_rows, f2 [n2, u_rows], wt [n2, n1], f1 [n1, n1])``,
    computed in float64 and cast to complex64.

    Index mapping (validated against np.fft): spectrum index
    ``k = k1*n2 + k2``; time index ``n = n1*u + v``.  Zero-padding a
    period-long block to NF makes only ``u < u_rows`` input rows
    nonzero, so the first stage is trimmed to them.
    """
    n1, n2 = split_nf(nf)
    u_rows = min(n2, -(-period // n1))
    k1, k2 = np.arange(n1), np.arange(n2)
    c64 = lambda a: np.exp(-2j * np.pi * a).astype(np.complex64)
    return (n1, n2, u_rows,
            c64(np.outer(k2, np.arange(u_rows)) / n2),
            c64(np.outer(k2, k1) / nf),
            c64(np.outer(k1, k1) / n1))


@functools.lru_cache(maxsize=8)
def _tap_vectors_np(nf: int, dsamp: float, period: int):
    """Fixed early/late tap vectors ``t(d)[k] = e^{-j2πk_eff d/NF}``.

    Signed frequencies (k_eff = k - NF for the upper half) match
    :func:`_frac_ramp`.  Returns (t(+d), t(+d-P), t(-d), t(-d+P)) — the
    second of each pair applies when the early/late lag wraps around the
    code period relative to the prompt.
    """
    k = np.arange(nf)
    keff = np.where(k >= nf // 2, k - nf, k)
    t = lambda d: np.exp(-2j * np.pi * keff * (d / nf)).astype(np.complex64)
    return t(dsamp), t(dsamp - period), t(-dsamp), t(-dsamp + period)


def code_spectra_np(prns, n_chan: int, fs: float) -> np.ndarray:
    """Host-side correlator spectra (see :func:`code_spectra`) as numpy.

    For callers that assemble per-channel rows dynamically (re-acquisition)
    and transfer via float planes (tpu_gnss.utils.xfer).
    """
    from ..acquire.folded import fft_len_for_period
    from ..signal.cacode import code_table, resample
    p = int(round(fs * 1e-3))
    nf = fft_len_for_period(p)
    tbl = code_table()
    reps = np.zeros((n_chan, p), np.float64)
    for ch in range(n_chan):
        prn = prns[ch] if ch < len(prns) else 1
        reps[ch] = resample(tbl[prn - 1], fs, p)
    spec = np.conj(np.fft.fft(reps, n=nf, axis=-1))
    if nf != p:
        k = np.arange(nf)
        spec = spec * (1.0 + np.exp(2j * np.pi * k * (p / nf)))[None, :]
    return spec.astype(np.complex64)


def code_spectra(prns, n_chan: int, fs: float) -> tuple[jnp.ndarray, int]:
    """Per-channel correlator spectra for the FFT-dot correlator.

    Returns ``(spec [n_chan, NF] complex64 on device, NF)`` where
    ``spec = conj(FFT(replica)) * (1 + e^{j2πkP/NF})`` — the second factor
    folds the circular-correlation wrap (circ(τ)=lin(τ)+lin(τ−P)) into
    the table so each correlator tap needs only one phase ramp at run
    time.  When NF == P the transform is already circular and the factor
    is omitted (it would be exactly 2).  Computed on device from the float32 replicas.
    """
    from ..acquire.folded import fft_len_for_period
    p = int(round(fs * 1e-3))
    nf = fft_len_for_period(p)
    reps = np.zeros((n_chan, p), np.float32)
    from ..signal.cacode import code_table, resample
    tbl = code_table()
    for ch, prn in enumerate(prns):
        reps[ch] = resample(tbl[prn - 1], fs, p)
    for ch in range(len(prns), n_chan):
        reps[ch] = resample(tbl[0], fs, p)

    @jax.jit
    def build(r):
        spec = jnp.conj(jnp.fft.fft(r.astype(jnp.complex64), n=nf, axis=-1))
        if nf == p:
            return spec
        k = jnp.arange(nf, dtype=jnp.float32)
        ang = 2.0 * jnp.pi * k * (p / nf)
        wrap = 1.0 + jax.lax.complex(jnp.cos(ang), jnp.sin(ang))
        return spec * wrap[None, :]

    return build(jnp.asarray(reps)), nf


def _ramp_split(nf: int) -> int:
    """Inner factor K for :func:`_frac_ramp`'s phase split.

    K must divide NF (the outer product reshapes to [rows, NF]) and
    NF//2 (so the signed-frequency boundary falls exactly between outer
    blocks).  Largest such K <= 128; pow2 NF gets 128, NF=10000 gets
    125, degenerate NF fall back toward 1 (correct, just more trig).
    """
    for k in range(min(128, nf), 0, -1):
        if nf % k == 0 and (nf // 2) % k == 0:
            return k
    return 1


def _frac_ramp(tau: jnp.ndarray, nf: int) -> jnp.ndarray:
    """``e^{-j2πk_eff τ/NF}`` with SIGNED frequencies — [rows, NF].

    ``k_eff = k`` for the lower half, ``k - NF`` for the upper half: for
    fractional τ the interpolation must treat upper bins as negative
    frequencies or the value collapses at half-sample lags.  The upper-
    half correction is a single ``e^{+j2πτ}`` factor.  Trig cost is
    K + NF/K per row via the phase split.
    """
    K = _ramp_split(nf)
    k1 = jnp.arange(K, dtype=jnp.float32)
    k2 = jnp.arange(nf // K, dtype=jnp.float32) * K
    a1 = -2.0 * jnp.pi * k1[None, :] * tau[:, None] / nf
    a2 = -2.0 * jnp.pi * k2[None, :] * tau[:, None] / nf
    e1 = jax.lax.complex(jnp.cos(a1), jnp.sin(a1))
    e2 = jax.lax.complex(jnp.cos(a2), jnp.sin(a2))
    at = 2.0 * jnp.pi * tau[:, None]
    upper = jax.lax.complex(jnp.cos(at), jnp.sin(at))
    e2 = jnp.where(k2[None, :] >= nf // 2, e2 * upper, e2)
    return (e2[:, :, None] * e1[:, None, :]).reshape(tau.shape[0], nf)


def stop_channel(state: ChannelState, ch: int) -> ChannelState:
    """Deactivate one channel (the SignalLost mask-clear analog,
    reference: c/channel.cpp:246-254)."""
    return state._replace(active=state.active.at[ch].set(False))


def channel_code_tables(prns, n_chan: int) -> np.ndarray:
    """``[n_chan, 1023]`` bipolar chips; unused channels get PRN 1."""
    tbl = 1.0 - 2.0 * cacode.code_table().astype(np.float32)
    out = np.tile(tbl[0], (n_chan, 1)).astype(np.float32)
    for ch, prn in enumerate(prns):
        out[ch] = tbl[prn - 1]
    return out


def carrier_pull_in(state: ChannelState, if_offset_hz: float = 0.0
                    ) -> ChannelState:
    """Re-seed the carrier loop from the locked code rate.

    The reference's acquisition-phase trick: the code loop always locks,
    so after a settling period the code Doppler gives a carrier Doppler
    estimate well inside the Costas capture range
    (reference: c/channel.cpp:190-207).  Resets the PLL integrator so the
    filter restarts around the new seed.
    """
    ca_dop = state.code_dev
    lo_dop = ca_dop * (L1_HZ / CHIP_RATE_HZ) + if_offset_hz
    return state._replace(
        carrier_seed=jnp.where(state.active, lo_dop, state.carrier_seed),
        pll_acc=jnp.where(state.active, 0.0, state.pll_acc))
