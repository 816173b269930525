#!/usr/bin/env python
"""Acquisition throughput on one GPU: full-grid GPS C/A search.

Measures the batched folded acquisition front end on device — 1-bit
quadrature mix, Doppler wipe-off + coherent fold, forward FFT, 32-PRN
circular correlation (spectrum product + inverse FFT), SNR peak search —
in samples*PRN*Doppler-bin per second, through
:func:`tpu_gnss.acquire.folded.acquire_folded_batch`.

Baseline: the reference's published cold-search rate, ~16 Msample*PRN*bin/s
on a 1.7 GHz Pentium (2.5 s for 32 PRNs x 41 bins x 4 ms @ 10 Msps;
reference: "Homemade GPS Receiver.html":213, BASELINE.md).

Fails when JAX finds no GPU.  Prints exactly one JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "platform": ..., "device_kind": ..., "device_count": N}
"""

import json
import sys
import time

import numpy as np

BASELINE_SAMPLE_PRN_BIN_PER_S = 16e6


def main() -> int:
    import jax
    import jax.numpy as jnp
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX's first device is {dev.platform!r}",
              file=sys.stderr)
        return 1
    from tpu_gnss.utils.jaxcache import enable_persistent_cache
    enable_persistent_cache()
    from tpu_gnss.config import SYNTHETIC as cfg
    from tpu_gnss.acquire import folded as F

    searcher = F.FoldedSearcher(cfg, n_coherent=4)
    rng = np.random.default_rng(0)
    n_blocks = 8
    bits_blocks = jnp.asarray(
        rng.integers(0, 2, (n_blocks, searcher.block_len), dtype=np.uint8))

    def step():
        return jax.block_until_ready(F.acquire_folded_batch(
            bits_blocks, searcher.code_ffts_p, searcher.dops_hz, fs=cfg.fs,
            lo_rate=cfg.lo_rate, n_coherent=searcher.n_coherent,
            dop_chunk=searcher.dop_chunk, from_bits=True,
            period=searcher.period))

    step()                                  # compile + first execution
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        step()
        times.append(time.perf_counter() - t0)
    dt = sorted(times)[len(times) // 2]

    grid = n_blocks * len(cfg.prns) * len(searcher.dops_hz) * searcher.block_len
    value = grid / dt
    print(json.dumps({
        "metric": "acquisition_throughput",
        "value": round(value / 1e6, 1),
        "unit": "Msample*PRN*bin/s",
        "vs_baseline": round(value / BASELINE_SAMPLE_PRN_BIN_PER_S, 1),
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
