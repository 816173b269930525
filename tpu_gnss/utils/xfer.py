"""Host<->device transfer helpers.

All framework code moves complex data across the host/device boundary
as real planes — float32, or quantized integers that cut the link bytes
— and combines/splits them on device.  Whether the quantized uplink
modes pay on a PCIe-attached GPU is not measured yet (ROADMAP).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


@jax.jit
def _combine(re: jnp.ndarray, im: jnp.ndarray) -> jnp.ndarray:
    return (re + 1j * im).astype(jnp.complex64)


def to_device_complex(x: np.ndarray) -> jax.Array:
    """Transfer a host complex array to device as float32 planes."""
    x = np.asarray(x)
    return _combine(jnp.asarray(np.ascontiguousarray(x.real, dtype=np.float32)),
                    jnp.asarray(np.ascontiguousarray(x.imag, dtype=np.float32)))


@jax.jit
def _combine_dequant(re_i8: jnp.ndarray, im_i8: jnp.ndarray,
                     inv_scale: jnp.ndarray) -> jnp.ndarray:
    re = re_i8.astype(jnp.float32) * inv_scale
    im = im_i8.astype(jnp.float32) * inv_scale
    return (re + 1j * im).astype(jnp.complex64)


def to_device_complex_i8(x: np.ndarray, scale: float) -> jax.Array:
    """Quantized transfer: complex host array -> int8 planes -> device.

    4x less host->device traffic than float32 planes.  The dequantize (x ~= i8 / scale) runs on device, so amplitudes (and
    everything downstream: correlator powers, AGC, watchdog ratios) are
    preserved up to the quantization step 1/scale.  Callers pick
    ``scale`` so the step is far below the noise floor (e.g.
    ``127 / (6 * rms)``).
    """
    x = np.asarray(x)
    q = lambda a: np.clip(np.rint(a * scale), -127, 127).astype(np.int8)
    return _combine_dequant(jnp.asarray(q(x.real)), jnp.asarray(q(x.imag)),
                            jnp.float32(1.0 / scale))


import functools


@functools.partial(jax.jit, static_argnames=("remove_dc",))
def _unpack_iq4(packed: jnp.ndarray, inv_scale: jnp.ndarray,
                remove_dc: bool) -> jnp.ndarray:
    """Packed int4 I/Q bytes (I = low nibble, Q = high) -> complex64."""
    b = packed.astype(jnp.int32)
    lo = b & 0xF
    lo = lo - jnp.where(lo >= 8, 16, 0)
    hi = (b >> 4) & 0xF
    hi = hi - jnp.where(hi >= 8, 16, 0)
    re = lo.astype(jnp.float32) * inv_scale
    im = hi.astype(jnp.float32) * inv_scale
    if remove_dc:
        re = re - jnp.mean(re)
        im = im - jnp.mean(im)
    return (re + 1j * im).astype(jnp.complex64)


def _pack_nibbles(qi: np.ndarray, qq: np.ndarray) -> np.ndarray:
    """Two int8 arrays in [-7, 7] -> one uint8 array of packed nibbles."""
    return ((qi & 0xF) | ((qq & 0xF) << 4)).astype(np.uint8)


def to_device_complex_i4(x: np.ndarray, scale: float) -> jax.Array:
    """4-bit quantized transfer: 1 byte/sample, half of the int8 planes.

    GPS signals are noise-dominated, so a ~3-sigma-scaled 4-bit uniform
    quantizer costs <0.1 dB of post-correlation SNR (vs ~2 dB for the
    1-bit capture format the reference itself uses everywhere) — the
    right trade when the host->device link, not device compute, bounds
    realtime factor.  Callers pick ``scale`` ~ 7/(3*rms).
    """
    x = np.asarray(x)
    qi = np.clip(np.rint(x.real * scale), -7, 7).astype(np.int8)
    qq = np.clip(np.rint(x.imag * scale), -7, 7).astype(np.int8)
    return _unpack_iq4(jnp.asarray(_pack_nibbles(qi, qq)),
                       jnp.float32(1.0 / scale), False)


def to_device_iq4(raw: np.ndarray, signed: bool,
                  remove_dc: bool = True) -> jax.Array:
    """8-bit capture bytes requantized to packed int4 for the link.

    Same output contract as :func:`to_device_iq8` (complex64 baseband,
    device-side DC removal) at half the transfer size; amplitudes are
    preserved up to the 4-bit step (scale is divided back out).

    The quantizer is a 256-entry byte lookup (every input byte maps to
    one nibble for a given scale), so host repacking costs three uint8
    passes instead of six float32 passes — measured ~10x cheaper, which
    matters because this runs per chunk on the streaming host
    (BENCH_e2e r4: the float path burned 2.9 s of a 3.4 s wall).
    """
    raw = np.asarray(raw)
    assert raw.dtype.itemsize == 1, (
        f"to_device_iq4 takes 8-bit capture bytes, got {raw.dtype}")
    head = raw[:65536].astype(np.float32)
    if not signed:
        head = head - 128.0
    rms = float(np.sqrt(np.mean(np.square(head))))
    scale = 7.0 / (3.0 * rms) if rms > 1e-12 else 1.0
    v = np.arange(256, dtype=np.uint8)
    v = (v.view(np.int8).astype(np.float32) if signed
         else v.astype(np.float32) - 128.0)
    q = (np.clip(np.rint(v * scale), -7, 7).astype(np.int32)
         & 0xF).astype(np.uint8)
    u = raw.view(np.uint8) if raw.dtype != np.uint8 else raw
    packed = q[u[0::2]] | (q << 4)[u[1::2]]
    return _unpack_iq4(jnp.asarray(packed),
                       jnp.float32(1.0 / scale), remove_dc)


#: 2-bit sign/magnitude dequant divisor: levels {±1, ±3}·(rms/_I2_RMS_DIV)
#: reproduce the input RMS (E[lvl²] = 0.68·1 + 0.32·9 = 3.56 at a ±1σ
#: threshold, sqrt = 1.887) — ONE constant shared by the byte-LUT and
#: host-complex quantizers so they can never drift apart.
_I2_RMS_DIV = 1.887


def _i2_code(v: np.ndarray, rms: float) -> np.ndarray:
    """2-bit sign/magnitude code: 2·negative + strong (levels ±1, ±3
    at a threshold of one RMS) — the single source of the mapping."""
    return (2 * (v < 0) + (np.abs(v) >= rms)).astype(np.uint8)


@functools.partial(jax.jit, static_argnames=("remove_dc",))
def _unpack_iq2(packed: jnp.ndarray, step: jnp.ndarray,
                remove_dc: bool) -> jnp.ndarray:
    """Packed 2-bit sign/magnitude I/Q -> complex64, on device.

    Each byte holds FOUR components (I0,Q0,I1,Q1), two bits each:
    code = 2*negative + strong, i.e. levels [+1, +3, -1, -3] * step.
    """
    b = packed.astype(jnp.int32)
    levels = jnp.array([1.0, 3.0, -1.0, -3.0], jnp.float32) * step
    c = jnp.stack([b & 3, (b >> 2) & 3, (b >> 4) & 3, (b >> 6) & 3],
                  axis=-1).reshape(-1)      # component stream
    v = levels[c].reshape(-1, 2)
    re, im = v[:, 0], v[:, 1]
    if remove_dc:
        re = re - jnp.mean(re)
        im = im - jnp.mean(im)
    return (re + 1j * im).astype(jnp.complex64)


def to_device_iq2(raw: np.ndarray, signed: bool,
                  remove_dc: bool = True) -> jax.Array:
    """8-bit capture bytes requantized to 2-bit sign/magnitude for the
    link: 4 components/byte = half a byte per complex sample — half of
    :func:`to_device_iq4`'s traffic, a quarter of the native int8 path.

    Standard GNSS front-end quantization (the classic 2-bit ADC most
    commercial L1 receivers run): sign + one magnitude bit with the
    threshold at the input RMS costs ~0.55 dB of post-correlation SNR
    (vs ~2 dB for the 1-bit capture format the reference itself uses
    everywhere, c/conv_1bit_bin_to_hackrf_bin.cpp:18-20), so fidelity
    is proven by the reference's own operating point.  Dequantization
    maps codes to levels {±1, ±3}·step with step = rms/1.887 so the
    output RMS matches the input (E[lvl²] = 0.68·1 + 0.32·9 = 3.56 at
    a ±1σ threshold) — AGC/watchdog power ratios downstream are
    preserved.

    Host cost: one 256-entry LUT pass per component plus three ORs —
    the same cheap byte-wise repacking recipe as the int4 path.
    """
    raw = np.asarray(raw)
    assert raw.dtype.itemsize == 1, (
        f"to_device_iq2 takes 8-bit capture bytes, got {raw.dtype}")
    assert len(raw) % 4 == 0, (
        "2-bit packing needs whole bytes of FOUR components: the "
        "complex sample count must be even")
    head = raw[:65536].astype(np.float32)
    if not signed:
        head = head - 128.0
    rms = float(np.sqrt(np.mean(np.square(head))))
    if rms <= 1e-12:
        rms = 1.0
    v = np.arange(256, dtype=np.uint8)
    v = (v.view(np.int8).astype(np.float32) if signed
         else v.astype(np.float32) - 128.0)
    code = _i2_code(v, rms)
    u = raw.view(np.uint8) if raw.dtype != np.uint8 else raw
    packed = (code[u[0::4]] | (code << 2)[u[1::4]]
              | (code << 4)[u[2::4]] | (code << 6)[u[3::4]])
    return _unpack_iq2(jnp.asarray(packed),
                       jnp.float32(rms / _I2_RMS_DIV), remove_dc)


def to_device_complex_i2(x: np.ndarray) -> jax.Array:
    """2-bit sign/magnitude transfer of a host COMPLEX array: half a
    byte per sample (see :func:`to_device_iq2` for the quantizer)."""
    x = np.asarray(x)
    assert len(x) % 2 == 0, "2-bit packing needs an even sample count"
    comps = np.empty((len(x), 2), np.float32)
    comps[:, 0] = x.real
    comps[:, 1] = x.imag
    comps = comps.reshape(-1)
    rms = float(np.sqrt(np.mean(np.square(comps[:131072]))))
    if rms <= 1e-12:
        rms = 1.0
    c = _i2_code(comps, rms).reshape(-1, 4)
    packed = c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)
    return _unpack_iq2(jnp.asarray(packed),
                       jnp.float32(rms / _I2_RMS_DIV), False)


@functools.partial(jax.jit, static_argnames=("signed", "remove_dc"))
def _deinterleave_iq8(raw: jnp.ndarray, signed: bool,
                      remove_dc: bool) -> jnp.ndarray:
    """Interleaved 8-bit I/Q bytes -> complex64 baseband, on device.

    ``raw`` is the capture file's own bytes (int8 HackRF / uint8
    rtl-sdr order, reference: proc_hackrf_bin_for_gps.m:10-16,
    proc_rtl_bin_for_gps.m:20-27); deinterleave, recenter, and the
    per-chunk DC removal (reference: gps_8bit_proc.m:23-26) all run on
    device so the host touches nothing but the file read.
    """
    v = raw.astype(jnp.float32)
    if not signed:
        v = v - 128.0
    v = v.reshape(-1, 2)
    re, im = v[:, 0], v[:, 1]
    if remove_dc:
        re = re - jnp.mean(re)
        im = im - jnp.mean(im)
    return (re + 1j * im).astype(jnp.complex64)


def to_device_iq8(raw: np.ndarray, signed: bool,
                  remove_dc: bool = True) -> jax.Array:
    """Upload native interleaved 8-bit I/Q bytes; convert on device.

    One transfer of the capture's own bytes (2 bytes/sample — no host
    quantize/deinterleave pass at all).  ``raw`` must already be viewed
    as the capture's dtype (int8 or uint8) so the upload preserves
    values exactly.
    """
    raw = np.asarray(raw)
    assert raw.dtype in (np.int8, np.uint8)
    return _deinterleave_iq8(jnp.asarray(raw), signed, remove_dc)


@jax.jit
def _split(c: jnp.ndarray):
    return jnp.real(c).astype(jnp.float32), jnp.imag(c).astype(jnp.float32)


def from_device_complex(c: jax.Array) -> np.ndarray:
    """Fetch a device complex array to host via float32 planes."""
    re, im = _split(c)
    return np.asarray(re) + 1j * np.asarray(im)
