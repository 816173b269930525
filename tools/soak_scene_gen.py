"""Soak-fixture generator (run as a subprocess of soak_payload).

Synthesizes the N-second 6-SV scene (segmented, bounded temporaries)
and writes the 1-bit IF capture + truth position.  Kept out-of-process
so the soak artifact's peak RSS measures the RECEIVER, not fixture
generation (whose dominant cost is the scene's own complex64 array —
~16 MB per capture second).  Forced onto the CPU: the parent holds the
card.

Usage: soak_scene_gen.py <out.bin> <duration_s> [drop_sv drop_t0 drop_t1]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np

from tpu_gnss.io import loaders
from tpu_gnss.signal.synth import baseband_to_1bit_if
import tests.test_e2e as E


def main(argv) -> int:
    path = argv[1]
    duration = float(argv[2])
    dropout = None
    if len(argv) > 3:
        dropout = (int(argv[3]), float(argv[4]), float(argv[5]))
    iq, ephs, rx = E.build_scene(duration=duration, dropout=dropout)
    fc = E.FS / 4
    seg = int(4.0 * E.FS) & ~7
    with open(path, "wb") as f:
        for s0 in range(0, len(iq), seg):
            bits = baseband_to_1bit_if(iq[s0: s0 + seg], fc, E.FS, n0=s0)
            f.write(loaders.pack_1bit(bits))
    np.save(path + ".rx.npy", np.asarray(rx))
    print(f"wrote {path} ({os.path.getsize(path)/1e6:.1f} MB)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
