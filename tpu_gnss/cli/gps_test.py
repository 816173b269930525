"""gps_test-compatible acquisition CLI.

Prints the same per-run block tables as the reference offline searcher so
outputs can be diffed against its golden results
(reference: c/test_search_offline.cpp, c/search_offline.cpp:219-292).

Two block-consumption modes:

* ``compat`` (default): exact reference behavior — each SV in the PRN sweep
  consumes its own fresh block, and each block advances the file by whole
  512-byte packets (ceil(fft_len/4096)*4096 samples = 40960 for the default
  40000-point FFT; the 960 leftover samples are discarded), matching the
  reference's packetized reader (reference: c/search_offline.cpp:129-139).
  One "run" therefore spans 32 blocks, each searched for one PRN.
* ``native``: every fft_len-sample block is searched for all 32 PRNs at
  once (one batched grid per block), stride fft_len.

Argument note: the reference accepts ``max_fo`` on the command line but
never assigns it (reference: c/test_search_offline.cpp:31-38 parses only
FC/FS), silently searching ±5 kHz even when the replay workflows pass
100000.  Here ``max_fo`` is honored as documented in the reference README;
pass ``--quirk-ignore-max-fo`` to reproduce the reference bug bit-for-bit.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..config import ReceiverConfig
from .search_runner import run_capture


def format_run_tables(run_count: int, hits: list[dict],
                      all_snr: np.ndarray) -> str:
    """Reference-format result tables (c/search_offline.cpp:264-287)."""
    lines = []
    lines.append(f"{run_count:2d} satellite: " +
                 "".join(f"{h['sv']:5d} " for h in hits))
    lines.append(f"{run_count:2d} SNR(>=25): " +
                 "".join(f"{h['snr']:5.1f} " for h in hits))
    lines.append(f"{run_count:2d}  lo_shift: " +
                 "".join(f"{h['lo_shift']:5d} " for h in hits))
    lines.append(f"{run_count:2d}  ca_shift: " +
                 "".join(f"{h['ca_shift']:5d} " for h in hits))
    lines.append("".join(f"{s:2.0f} " for s in all_snr))
    lines.append("")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="gps_test",
        description="GPS C/A code offline search on an accelerator "
                    "(gps_test-compatible output)")
    p.add_argument("filename", help="bit-packed 1-bit IF capture")
    p.add_argument("fc", type=float, nargs="?", default=4.092e6,
                   help="carrier freq @ IF (default Nottingham 4.092e6)")
    p.add_argument("fs", type=float, nargs="?", default=5.456e6,
                   help="sampling rate (default 5.456e6)")
    p.add_argument("max_fo", type=float, nargs="?", default=5000.0,
                   help="max Doppler searched, Hz")
    p.add_argument("--mode", choices=["compat", "native", "folded"],
                   default="compat",
                   help="compat: reference-exact block sweep; native: all "
                        "PRNs per block; folded: fast folded engine")
    p.add_argument("--threshold", type=float, default=25.0)
    p.add_argument("--max-runs", type=int, default=None)
    p.add_argument("--quirk-ignore-max-fo", action="store_true",
                   help="reproduce the reference bug where argv max_fo is "
                        "parsed but never applied (stays 5000)")
    args = p.parse_args(argv)
    from ..utils.jaxcache import enable_persistent_cache
    enable_persistent_cache()

    max_fo = 5000.0 if args.quirk_ignore_max_fo else args.max_fo
    cfg = ReceiverConfig(fs=args.fs, fc=args.fc, max_fo=max_fo,
                         snr_threshold=args.threshold)

    import os
    if not os.path.exists(args.filename):
        print(f"can not open file: {args.filename}", file=sys.stderr)
        return 2
    print("tpu_gnss C/A code offline search "
          "(capability parity with gps_test; JAX backend)")
    print(f"file={args.filename} fc={args.fc:g} fs={args.fs:g} "
          f"max_fo={max_fo:g} mode={args.mode}")

    for run in run_capture(args.filename, cfg, mode=args.mode,
                           max_runs=args.max_runs):
        sys.stdout.write(format_run_tables(run["run"], run["hits"],
                                           run["all_snr"]) + "\n")
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
