"""Device-side 1-bit frontend: packed-word unpack + quadrature mix.

Captures are bit-packed (LSB-first, reference: c/search_offline.cpp:141-146).
Transferring packed uint32 words to the device and unpacking there cuts
host->device traffic 8x versus sending unpacked bytes.  The unpack
(shift/mask) and the factored square-wave LO mix are plain XLA, fused by
the compiler into the consumer's program.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def pack_bits_to_words(bits: np.ndarray) -> np.ndarray:
    """Host-side: {0,1} sample array -> little-endian uint32 words."""
    bits = np.asarray(bits, dtype=np.uint8)
    pad = (-len(bits)) % 32
    if pad:
        bits = np.concatenate([bits, np.zeros(pad, np.uint8)])
    return np.packbits(bits, bitorder="little").view(np.uint32)


def packed_words_from_file_bytes(raw: bytes) -> np.ndarray:
    """Capture-file bytes -> uint32 words (same LSB-first bit order)."""
    buf = np.frombuffer(raw, dtype=np.uint8)
    pad = (-len(buf)) % 4
    if pad:
        buf = np.concatenate([buf, np.zeros(pad, np.uint8)])
    return buf.view(np.uint32)


def unpack_bits(words: jnp.ndarray, n_bits: int) -> jnp.ndarray:
    """uint32 words -> {0,1} int32 bit array (LSB-first), length n_bits."""
    k = jnp.arange(32, dtype=jnp.uint32)
    bits = (words[:, None] >> k[None, :]) & jnp.uint32(1)
    return bits.reshape(-1)[:n_bits].astype(jnp.int32)


@functools.partial(jax.jit,
                   static_argnames=("n_bits", "lo_rate", "variant"))
def mix_packed(words: jnp.ndarray, *, n_bits: int, lo_rate: float,
               variant: str = "offline",
               phase0_quarters=0.0) -> jnp.ndarray:
    """Packed words -> complex64 baseband (XLA path).

    Bit-exact with :func:`tpu_gnss.acquire.search.mix_baseband` on the
    same bits by construction (unpack + that very mix in one jit).
    ``phase0_quarters`` keeps the LO continuous across streamed chunks
    (traced scalar; see mix_baseband).
    """
    from ..acquire.search import mix_baseband
    bits = unpack_bits(words, n_bits)
    return mix_baseband(bits, lo_rate, variant,
                        phase0_quarters=phase0_quarters)
