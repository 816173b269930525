"""Device-side packed 1-bit frontend tests."""

import numpy as np
import jax.numpy as jnp
import pytest

from tpu_gnss.acquire.search import mix_baseband
from tpu_gnss.config import NOTTINGHAM, SYNTHETIC
from tpu_gnss.ops import onebit


def test_pack_unpack_roundtrip(rng):
    bits = rng.integers(0, 2, 4096 + 17).astype(np.uint8)
    words = onebit.pack_bits_to_words(bits)
    got = np.asarray(onebit.unpack_bits(jnp.asarray(words), len(bits)))
    np.testing.assert_array_equal(got, bits)


def test_words_from_file_bytes(rng):
    from tpu_gnss.io import loaders
    bits = rng.integers(0, 2, 8 * 1000).astype(np.uint8)
    raw = loaders.pack_1bit(bits)
    words = onebit.packed_words_from_file_bytes(raw)
    got = np.asarray(onebit.unpack_bits(jnp.asarray(words), len(bits)))
    np.testing.assert_array_equal(got, bits)


@pytest.mark.parametrize("cfg", [NOTTINGHAM, SYNTHETIC])
def test_mix_packed_matches_mix_baseband(cfg, rng):
    n = 40000
    bits = rng.integers(0, 2, n).astype(np.uint8)
    want = np.asarray(mix_baseband(jnp.asarray(bits), cfg.lo_rate))
    words = onebit.pack_bits_to_words(bits)
    got = np.asarray(onebit.mix_packed(jnp.asarray(words), n_bits=n,
                                       lo_rate=cfg.lo_rate))
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_mix_packed_phase_continuity(rng):
    """Chunked mix_packed with running phase0 == one whole-capture mix."""
    cfg = NOTTINGHAM
    n, chunk = 64000, 16000          # word-aligned chunks
    bits = rng.integers(0, 2, n).astype(np.uint8)
    want = np.asarray(mix_baseband(jnp.asarray(bits), cfg.lo_rate))
    got = np.concatenate([
        np.asarray(onebit.mix_packed(
            jnp.asarray(onebit.pack_bits_to_words(bits[i:i + chunk])),
            n_bits=chunk, lo_rate=cfg.lo_rate,
            phase0_quarters=jnp.float32((i * float(cfg.lo_rate)) % 4.0)))
        for i in range(0, n, chunk)])
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_acquire_packed_matches_regular():
    from tpu_gnss.config import ReceiverConfig
    from tpu_gnss.acquire.folded import FoldedSearcher
    from tpu_gnss.signal import synth
    cfg = ReceiverConfig(fs=2.048e6, fc=0.512e6, max_fo=5000.0,
                         fft_len=4096)
    f = FoldedSearcher(cfg, n_coherent=4)
    sv = synth.SvSignal(prn=13, doppler_hz=600.0, code_phase_chips=200.0)
    iq = synth.synth_baseband([sv], cfg.fs, f.block_len, noise_std=0.5,
                              seed=2)
    bits = synth.baseband_to_1bit_if(iq, cfg.fc, cfg.fs)
    want = f.acquire(bits=bits)
    got = f.acquire_packed(bits)
    assert int(got.ca_shift[12]) == int(want.ca_shift[12])
    np.testing.assert_allclose(float(got.snr[12]), float(want.snr[12]),
                               rtol=1e-5)
