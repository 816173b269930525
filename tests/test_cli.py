"""gps_test-compatible CLI regression tests against the golden snapshot.

The golden file is this framework's output on the checked-in reference
capture (PRN 8 synthetic, README §1.1); the underlying math is tied to the
reference's semantics by the loop-form oracle tests.  This test locks the
CLI's block handling + table formatting against regressions.
"""

import contextlib
import io
import os

import numpy as np

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "gps_sig_tmp_compat.txt")


def test_compat_cli_matches_golden(synth_fixture_path):
    from tpu_gnss.cli.gps_test import main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main([synth_fixture_path, "2.046e6", "8.184e6", "5000",
              "--max-runs", "2"])
    got = buf.getvalue().splitlines()
    start = next(i for i, l in enumerate(got) if l.startswith(" 0 satellite:"))
    got = got[start:start + 12]
    want = open(GOLDEN).read().splitlines()[:12]
    assert got == want


def test_golden_file_prn8_dominates():
    lines = open(GOLDEN).read().splitlines()
    sat_rows = [l for l in lines if "satellite:" in l]
    assert len(sat_rows) == 12
    for row in sat_rows:
        svs = [int(x) for x in row.split(":")[1].split()]
        assert 7 in svs, f"sv 7 (PRN 8) missing in {row!r}"


def test_native_mode_runs(synth_fixture_path):
    from tpu_gnss.cli.gps_test import main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main([synth_fixture_path, "2.046e6", "8.184e6", "5000",
              "--mode", "native", "--max-runs", "1"])
    out = buf.getvalue()
    assert " 0 satellite:" in out
    # native mode: PRN 8 (sv 7) detected on the very first block
    sat_row = [l for l in out.splitlines() if l.startswith(" 0 satellite:")][0]
    assert " 7 " in sat_row


def test_quirk_ignore_max_fo(synth_fixture_path):
    """The reference bug flag pins max_fo to 5000 regardless of argv."""
    from tpu_gnss.cli.gps_test import main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main([synth_fixture_path, "2.046e6", "8.184e6", "999999",
              "--quirk-ignore-max-fo", "--max-runs", "1"])
    assert "max_fo=5000" in buf.getvalue()


def test_folded_mode_runs(synth_fixture_path):
    """Fast-engine capture scan finds PRN 8 on the first coherent block."""
    from tpu_gnss.cli.gps_test import main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main([synth_fixture_path, "2.046e6", "8.184e6", "5000",
              "--mode", "folded", "--max-runs", "2"])
    out = buf.getvalue()
    sat_row = [l for l in out.splitlines()
               if l.startswith(" 0 satellite:")][0]
    assert " 7 " in sat_row


def test_convert_cli_roundtrip(tmp_path, synth_fixture_path):
    """convert CLI: 1bit -> iq8 -> (hackrf) 1bit round trip detects PRN 8."""
    from tpu_gnss.cli.convert import main as cmain
    iq8 = tmp_path / "tx.bin"
    back = tmp_path / "back.bin"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cmain(["1bit-to-iq8", synth_fixture_path, str(iq8),
                      "--fs", "8184000"]) == 0
        assert cmain(["hackrf-to-1bit", str(iq8), str(back),
                      "--fc", "2046000", "--fs", "8184000"]) == 0
    assert "wrote" in buf.getvalue()
    from tpu_gnss.config import ReceiverConfig
    from tpu_gnss.io import loaders
    from tpu_gnss.acquire.search import Searcher
    cfg = ReceiverConfig(fs=8.184e6, fc=2.046e6, max_fo=5000.0)
    bits = loaders.load_1bit(str(back), count=cfg.fft_len)
    s = Searcher(cfg)
    dets = s.detections(s.acquire_bits(bits))
    assert any(d["prn"] == 8 for d in dets)
    # missing input -> clean error
    assert cmain(["wav-to-1bit", str(tmp_path / "nope.wav"),
                  str(tmp_path / "x.bin")]) == 2


def test_warmup_cli_seeds_exported_cache(tmp_path):
    """The warmup CLI (the reference's pre-built-bitstream analog) runs
    the pipeline once over noise and leaves exported programs behind —
    the artifact that makes the NEXT process boot warm."""
    import os
    import subprocess
    import sys
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-m", "tpu_gnss.cli.warmup",
         "0.512e6", "2.048e6", "5000", "--fft-len", "4096",
         "--chunk-s", "1", "--channels", "4"],
        capture_output=True, text=True, timeout=900, env=env, cwd=repo)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    exp = tmp_path / "exported"
    blobs = ([f.name for f in exp.iterdir() if f.name.endswith(".jaxexp")]
             if exp.is_dir() else [])
    assert blobs, (r.stdout, r.stderr[-1000:])
