"""Boot-cache warmup: pre-compile + export a session's hot-path programs.

The reference ships a PRE-BUILT FPGA bitstream — synthesis happens once
at the workbench, and every field boot just loads it
(reference: c/main.cpp:14-38).  This CLI is that workbench step for the
receiver: it runs the full streaming pipeline once over synthetic
noise at the session's exact shapes, which compiles every hot-path
program (cold acquisition at k=1 AND the weak-signal escalation, the
tracking bank, channel seeding, the packed/raw uplink converters) into
the persistent XLA compile cache and the exported-program cache
(utils.progcache, both placed by utils.jaxcache).  After a warmup, the
FIRST real session boots at the warm cost instead of paying the
one-time compile.

Usage::

    python -m tpu_gnss.cli.warmup --preset nottingham
    python -m tpu_gnss.cli.warmup 4.092e6 5.456e6 5000 --channels 12 \
        --chunk-s 4 --format 1bit

Run it once per (code version, capture geometry); it is idempotent and
cheap when the caches are already hot.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="warmup",
        description="pre-compile + export the receiver's hot-path "
                    "programs for a capture geometry")
    p.add_argument("fc", type=float, nargs="?", default=4.092e6)
    p.add_argument("fs", type=float, nargs="?", default=5.456e6)
    p.add_argument("max_fo", type=float, nargs="?", default=5000.0)
    p.add_argument("--preset", default=None,
                   choices=["live", "nottingham", "synthetic", "rtlsdr",
                            "hackrf"])
    p.add_argument("--format", choices=["1bit", "iq8", "iqu8"],
                   default="1bit")
    p.add_argument("--channels", type=int, default=12)
    p.add_argument("--chunk-s", type=float, default=4.0)
    p.add_argument("--fft-len", type=int, default=40000)
    p.add_argument("--threshold", type=float, default=25.0)
    args = p.parse_args(argv)

    from ..utils.jaxcache import enable_persistent_cache
    enable_persistent_cache()

    from ..config import PRESETS, ReceiverConfig
    if args.preset:
        base = PRESETS[args.preset]
        args.fc, args.fs, args.max_fo = base.fc, base.fs, base.max_fo
    cfg = ReceiverConfig(fs=args.fs, fc=args.fc, max_fo=args.max_fo,
                         fft_len=args.fft_len,
                         snr_threshold=args.threshold,
                         num_chans=args.channels)

    import numpy as np

    from ..receiver import Receiver
    from ..utils import progcache

    t0 = time.perf_counter()
    # Two chunks of noise: enough for the stream loop to run cold
    # acquisition (finds nothing -> ALSO compiles the weak-signal
    # escalation program), dispatch + drain a tracking chunk (the
    # prewarm threads compile the tracker/seeder regardless of lock),
    # and exercise the uplink converter for the chosen format.
    n = int(2 * max(args.chunk_s, 1.0) * cfg.fs)
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory(prefix="tpu_gnss_warm_") as td:
        path = os.path.join(td, "noise.bin")
        if args.format == "1bit":
            from ..io import loaders
            from ..io.stream import FileSource1Bit
            bits = rng.integers(0, 2, n, dtype=np.uint8)
            with open(path, "wb") as f:
                f.write(loaders.pack_1bit(bits))
            src = FileSource1Bit(path, cfg)
        else:
            from ..io.stream import IQFileSource
            dtype = "int8" if args.format == "iq8" else "uint8"
            raw = rng.integers(0, 256, 2 * n).astype(np.uint8)
            if dtype == "int8":
                raw = raw.view(np.int8)
            raw.tofile(path)
            src = IQFileSource(path, cfg.fs, dtype=dtype)
        recv = Receiver(cfg)
        recv.process_source(src, chunk_s=max(args.chunk_s, 1.0))
    t_run = time.perf_counter() - t0

    # the exports land from daemon threads — exiting early would throw
    # away exactly the artifact this command exists to produce
    progcache.wait_exports(timeout=120.0)
    exp_dir = progcache._DIR
    n_exp = (len([f for f in os.listdir(exp_dir)
                  if f.endswith(".jaxexp")])
             if exp_dir and os.path.isdir(exp_dir) else 0)
    print(f"warmup: pipeline pass {t_run:.1f}s; "
          f"{n_exp} exported programs in {exp_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
