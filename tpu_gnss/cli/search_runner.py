"""Capture-level acquisition runners (streaming block pipeline).

The streaming analog of the reference's SearchTask file loop
(reference: c/search_offline.cpp:219-292), with the two block-consumption
modes described in :mod:`tpu_gnss.cli.gps_test`.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from ..config import ReceiverConfig
from ..io import loaders
from ..acquire.search import AcqResult, Searcher

PACKET_BYTES = 512  # reference fread granularity (c/search_offline.cpp:129)


def block_stride_samples(fft_len: int) -> int:
    """Samples consumed per reference block: whole 512-byte packets."""
    bits_per_packet = PACKET_BYTES * 8
    packets = -(-fft_len // bits_per_packet)
    return packets * bits_per_packet


def _result_to_run(searcher: Searcher, run: int, res: AcqResult) -> dict:
    snr = np.asarray(res.snr)
    hits = searcher.detections(res)
    return dict(run=run, hits=hits, all_snr=snr,
                lo_shift=np.asarray(res.lo_shift),
                ca_shift=np.asarray(res.ca_shift))


def run_capture(path: str, cfg: ReceiverConfig, mode: str = "compat",
                max_runs: Optional[int] = None) -> Iterator[dict]:
    """Stream a 1-bit capture through acquisition, yielding per-run results.

    compat: one run = len(prns) consecutive blocks, block i searched for
    PRN prns[i] only, stride = whole-packet block size.  A run is emitted
    only if all its blocks were fully read (the reference bails mid-run at
    EOF without printing, c/search_offline.cpp:241-261).

    native: one run = one fft_len block searched for all PRNs, stride
    fft_len.

    folded: one run = one coherent block (4 code periods) through the
    folded engine; the fast whole-capture scan mode.
    """
    n_sv = len(cfg.prns)
    if mode == "compat":
        searcher = Searcher(cfg)
        stride_bits = block_stride_samples(cfg.fft_len)
        stride_bytes = stride_bits // 8
        run = 0
        with open(path, "rb") as f:
            while max_runs is None or run < max_runs:
                raw = f.read(stride_bytes * n_sv)
                if len(raw) < stride_bytes * n_sv:
                    break
                bits = loaders.unpack_1bit(raw).reshape(n_sv, stride_bits)
                res = searcher.acquire_bits_paired(bits[:, :cfg.fft_len])
                yield _result_to_run(searcher, run, res)
                run += 1
    elif mode == "native":
        searcher = Searcher(cfg)
        block_bytes = cfg.fft_len // 8
        assert cfg.fft_len % 8 == 0
        run = 0
        with open(path, "rb") as f:
            while max_runs is None or run < max_runs:
                raw = f.read(block_bytes)
                if len(raw) < block_bytes:
                    break
                bits = loaders.unpack_1bit(raw)
                res = searcher.acquire_bits(bits)
                yield _result_to_run(searcher, run, res)
                run += 1
    elif mode == "folded":
        import jax.numpy as jnp
        from ..acquire.folded import FoldedSearcher
        fsearch = FoldedSearcher(cfg)
        need = fsearch.block_len
        buf = np.zeros(0, np.uint8)
        run = 0
        with open(path, "rb") as f:
            while max_runs is None or run < max_runs:
                while len(buf) < need:
                    raw = f.read(1 << 20)
                    if not raw:
                        break
                    buf = np.concatenate([buf, loaders.unpack_1bit(raw)])
                if len(buf) < need:
                    break
                bits, buf = buf[:need], buf[need:]
                res = fsearch.acquire(bits=jnp.asarray(bits))
                hits = fsearch.detections(res)
                yield dict(run=run, hits=hits,
                           all_snr=np.asarray(res.snr),
                           lo_shift=np.asarray(
                               np.round(np.asarray(res.doppler_hz)
                                        / cfg.dop_bin_hz)).astype(int),
                           ca_shift=np.asarray(res.ca_shift))
                run += 1
    else:
        raise ValueError(f"unknown mode {mode!r}")
