"""Wide-Doppler (+/-100 kHz) acquisition throughput on the device.

Replay captures need +/-100 kHz Doppler grids because of TX/RX oscillator
offsets (reference README.md section 2.1e: gps_test ... 0.62e6 2.8e6
100000); the grid is ~20x the live +/-5 kHz one.  Same measurement as
bench.py (batched folded acquisition, median of timed calls ending in
``block_until_ready``).  Prints one JSON line.
"""
import sys, os; sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import json
import time

import numpy as np

from tpu_gnss.utils.jaxcache import enable_persistent_cache
enable_persistent_cache()

import jax
import jax.numpy as jnp

from tpu_gnss.config import ReceiverConfig
from tpu_gnss.acquire import folded as F

BASELINE_SAMPLE_PRN_BIN_PER_S = 16e6   # reference CPU rate (BASELINE.md)

cfg = ReceiverConfig(fs=8.184e6, fc=2.046e6, max_fo=100000.0)
searcher = F.FoldedSearcher(cfg, n_coherent=4)
rng = np.random.default_rng(0)
n_blocks = 8

bits_blocks = jnp.asarray(
    rng.integers(0, 2, (n_blocks, searcher.block_len), dtype=np.uint8))
n_dop = len(searcher.dops_hz)
print(f"grid: {len(cfg.prns)} PRN x {n_dop} bins x {searcher.block_len} "
      f"samples, dop_chunk={searcher.dop_chunk}", flush=True)


def step():
    return jax.block_until_ready(F.acquire_folded_batch(
        bits_blocks, searcher.code_ffts_p, searcher.dops_hz, fs=cfg.fs,
        lo_rate=cfg.lo_rate, n_coherent=searcher.n_coherent,
        dop_chunk=searcher.dop_chunk, from_bits=True,
        period=searcher.period))


step()   # compile + first execution
times = []
for _ in range(5):
    t0 = time.perf_counter()
    step()
    times.append(time.perf_counter() - t0)
dt = sorted(times)[2]

grid = n_blocks * len(cfg.prns) * n_dop * searcher.block_len
value = grid / dt
dev = jax.devices()[0]
print(json.dumps(dict(metric="acquisition_throughput_widegrid",
                      value=value / 1e6, unit="Msample*PRN*bin/s",
                      vs_baseline=value / BASELINE_SAMPLE_PRN_BIN_PER_S,
                      n_doppler_bins=int(n_dop), max_fo_hz=cfg.max_fo,
                      fs_hz=cfg.fs, block_len=int(searcher.block_len),
                      platform=dev.platform, device_kind=dev.device_kind)))
