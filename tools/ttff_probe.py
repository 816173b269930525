"""Fresh-process cold TTFF probe: process start -> first fix.

Run as a subprocess of tools/e2e_payload.py twice, against the scene
files the payload already built:

- with the shared persistent compile cache (hot): the boot-once cost
  model — the reference pays its FPGA bitstream load once per power-up
  (c/main.cpp:14-38), this framework pays one compile per (shape,
  version) and every later process start deserializes it.
- with JAX_COMPILATION_CACHE_DIR pointed at an empty dir: the
  first-ever-boot number (trace + full XLA compile).

Prints one line ``TTFF_RESULT {json}`` with:
  ttff_s        process start (before jax import) -> first fix
  ttff_ctor_s   Receiver construction -> first fix (the convention
                of tools/e2e_payload.py's in-process passes)
  import_s      interpreter start -> jax client ready
  stages        per-stage wall breakdown of the run
"""
import sys, os, time

T_START = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

bit_path = sys.argv[1]
fs = float(sys.argv[2])
chunk_s = float(sys.argv[3]) if len(sys.argv) > 3 else 4.0

from tpu_gnss.utils.jaxcache import enable_persistent_cache
enable_persistent_cache()

import numpy as np
import jax, jax.numpy as jnp
np.asarray(jnp.arange(2) + 1)          # force backend init
t_import = time.perf_counter() - T_START

from tpu_gnss.config import ReceiverConfig
from tpu_gnss.io.stream import FileSource1Bit
from tpu_gnss.receiver import Receiver
from tpu_gnss.utils import metrics

cfg = ReceiverConfig(fs=fs, fc=fs / 4, max_fo=5000.0, fft_len=4096,
                     snr_threshold=17.0, num_chans=12)
t_ctor = time.perf_counter()
fixes = []
recv = Receiver(cfg)
recv.process_source(
    FileSource1Bit(bit_path, cfg), max_channels=8, chunk_s=chunk_s,
    on_solution=lambda s: fixes.append(time.perf_counter()))
t_end = time.perf_counter()

import json
out = dict(
    ttff_s=round(fixes[0] - T_START, 2) if fixes else None,
    ttff_ctor_s=round(fixes[0] - t_ctor, 2) if fixes else None,
    import_s=round(t_import, 2),
    wall_s=round(t_end - t_ctor, 2),
    n_fixes=len(fixes),
    stages={k: round(sum(v), 3)
            for k, v in metrics.METRICS.timings.items()})
print("TTFF_RESULT " + json.dumps(out), flush=True)
