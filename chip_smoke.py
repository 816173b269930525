#!/usr/bin/env python3
"""On-card smoke test: the receiver's main path on one GPU, checked.

Usage::

    python3 chip_smoke.py                # one card: phases 0-6
    python3 chip_smoke.py --four-cards   # the mesh receiver on 4 cards
                                         # against the same run on one

Phases (one process, one card; any failure exits non-zero):

0. Device: the card's ``nvidia-smi`` name and power limit, the JAX device
   list; fails unless JAX's first device is a GPU.  Also audits that the
   package imports no third-party module beyond JAX, numpy and scipy.
1. Acquisition at the reference's flagship geometry (Nottingham: 5.456
   Msps, 4.092 MHz IF, 32 PRN x 73 bins): the published 5-SV table,
   rebuilt synthetically, through the exact-semantics engine and the
   receiver's cold-search engine; one cold search on the +-100 kHz
   replay grid; both cold-search engines timed.
2. Tracking: the 12-channel bank at 5.456 MHz, FFT-dot correlators
   against the reference-style gather correlators.
3. Full receiver on a 20 s 6-SV scene written as a packed 1-bit IF file.
4. The same scene as an int8 interleaved IQ file.
5. Wall and first-fix times of phases 3-4 (information, not records).
6. Last line: ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result line, when JAX finds no GPU; it never
carries on on the CPU.
"""

from __future__ import annotations

import argparse
import ast
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# Nottingham capture's published 5-SV table: (prn, lo_shift, ca_shift)
# (reference: README gps_test output; BASELINE.md).
NOTTINGHAM_GOLDEN = [(1, 6, 1465), (21, 8, 686), (29, -9, 3868),
                     (30, -9, 2998), (31, -8, 2337)]


class PhaseFailure(AssertionError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise PhaseFailure(msg)


def median_s(fn, reps: int) -> float:
    """Median wall seconds of ``fn()`` (which must end in a host fetch
    or ``block_until_ready``)."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


# ----------------------------------------------------------------------
# phase 0
def card_line() -> str:
    """``nvidia-smi`` name and power limit of the card(s)."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise PhaseFailure(f"nvidia-smi unavailable: {e!r}")
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip()


def require_gpu():
    """JAX's devices; raises unless the first is a GPU."""
    import jax
    devs = jax.devices()
    print(f"jax {jax.__version__} devices: {devs}", flush=True)
    check(devs[0].platform == "gpu",
          f"no GPU: JAX's first device is {devs[0].platform!r}")
    return devs


def _required_imports(node, optional: bool = False):
    """Top-level names of the imports under ``node`` that are not inside
    a ``try`` whose handlers catch ImportError (optional extras, e.g. the
    NMEA monitor's pyserial)."""
    if isinstance(node, ast.Try):
        caught = {ast.unparse(h.type) for h in node.handlers if h.type}
        guarded = bool(caught & {"ImportError", "ModuleNotFoundError"})
        for child in node.body:
            yield from _required_imports(child, optional or guarded)
        for child in node.handlers + node.orelse + node.finalbody:
            yield from _required_imports(child, optional)
        return
    if not optional:
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
    for child in ast.iter_child_nodes(node):
        yield from _required_imports(child, optional)


def audit_imports() -> set:
    """Top-level third-party modules the package's sources require."""
    allowed = {"jax", "jaxlib", "numpy", "scipy", "tpu_gnss"}
    found = set()
    root = os.path.join(REPO, "tpu_gnss")
    check(os.path.isdir(root), f"package not found beside {__file__}")
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    found |= set(_required_imports(ast.parse(fh.read())))
    third = found - set(sys.stdlib_module_names)
    check(third <= allowed, f"package imports {sorted(third - allowed)}")
    return third


# ----------------------------------------------------------------------
# phase 1
def nottingham_bits():
    """Synthetic rebuild of the Nottingham capture's first window."""
    from tpu_gnss.config import NOTTINGHAM as cfg
    from tpu_gnss.signal import synth
    svs = [synth.SvSignal(prn=prn, doppler_hz=lo * cfg.dop_bin_hz,
                          code_phase_chips=ca * 1023.0 / cfg.lags,
                          amplitude=1.0)
           for prn, lo, ca in NOTTINGHAM_GOLDEN]
    iq = synth.synth_baseband(svs, cfg.fs, cfg.fft_len, noise_std=1.5,
                              seed=29)
    return synth.baseband_to_1bit_if(iq, cfg.fc, cfg.fs)


def check_golden(rows: dict, engine: str) -> None:
    """``rows``: prn -> (snr, lo_shift, ca_shift)."""
    for prn, lo, ca in NOTTINGHAM_GOLDEN:
        check(prn in rows, f"{engine}: PRN {prn} not detected")
        snr, got_lo, got_ca = rows[prn]
        print(f"  {engine}: PRN {prn:2d} snr {snr:8.1f} lo_shift {got_lo:3d} "
              f"(want {lo:3d}) ca_shift {got_ca:9.2f} (want {ca})",
              flush=True)
        check(snr >= 25.0, f"{engine}: PRN {prn} SNR {snr} < 25")
        check(got_lo == lo, f"{engine}: PRN {prn} lo_shift {got_lo}")
        check(abs(got_ca - ca) <= 1.0, f"{engine}: PRN {prn} ca_shift {got_ca}")


def time_cold_engines(searcher, bits, label: str) -> dict:
    """Median wall time of one cold search through each engine: the
    refined one-program search and the full-grid fetch + host refine."""
    refined = lambda: searcher.detections_refined_fast(bits=bits)
    grid = lambda: searcher.detections_refined(searcher.power_grid(bits=bits))
    refined(), grid()                                   # compile
    out = dict(refined_s=median_s(refined, 5), grid_s=median_s(grid, 5))
    print(f"  {label} cold search wall (median of 5): refined "
          f"{out['refined_s'] * 1e3:.2f} ms, grid {out['grid_s'] * 1e3:.2f} ms",
          flush=True)
    return out


def phase_acquisition() -> dict:
    import numpy as np
    import jax.numpy as jnp
    from tpu_gnss.acquire.folded import acquire_refined
    from tpu_gnss.acquire.search import Searcher
    from tpu_gnss.config import NOTTINGHAM, RTLSDR_REPLAY
    from tpu_gnss.receiver import Receiver
    from tpu_gnss.signal import synth

    bits = nottingham_bits()
    s = Searcher(NOTTINGHAM)
    res = s.acquire_bits(bits)
    snr, lo, ca = (np.asarray(a) for a in res)
    check_golden({p: (float(snr[p - 1]), int(lo[p - 1]), float(ca[p - 1]))
                  for p in NOTTINGHAM.prns}, "exact")

    recv = Receiver(NOTTINGHAM)
    engine = recv._resolve_engine()
    check(engine == "refined", f"auto engine resolved to {engine!r}")
    fs = recv.searcher
    dets = fs.detections_refined_fast(bits=bits)
    check_golden({d["prn"]: (d["snr"], d["lo_shift"], d["ca_shift"])
                  for d in dets}, engine)
    times = dict(flagship=time_cold_engines(fs, bits, "flagship"))

    # +-100 kHz replay grid, one SV at +75 kHz (at the preset's rate)
    cfg = RTLSDR_REPLAY
    ws = Receiver(cfg).searcher
    sv = synth.SvSignal(prn=21, doppler_hz=75000.0, code_phase_chips=700.0)
    iq = synth.synth_baseband([sv], cfg.fs, cfg.fft_len, noise_std=0.5,
                              seed=13)
    wbits = synth.baseband_to_1bit_if(iq, cfg.fc, cfg.fs)
    dets = ws.detections_refined_fast(bits=wbits)
    best = max(dets, key=lambda d: d["snr"]) if dets else None
    check(best is not None and best["prn"] == 21,
          f"wide grid: PRN 21 not the strongest detection: {dets}")
    print(f"  wide grid ({len(ws.dops_hz)} bins): PRN 21 snr "
          f"{best['snr']:.1f} doppler {best['doppler_hz']:.1f} Hz "
          f"ca_shift {best['ca_shift']:.2f}", flush=True)
    check(best["snr"] >= 25.0, "wide grid: SNR below threshold")
    check(abs(best["doppler_hz"] - 75000.0) <= 70.0,
          f"wide grid: Doppler {best['doppler_hz']}")
    want_ca = 700.0 / 1023.0 * ws.period
    check(abs(best["ca_shift"] - want_ca) <= 2.0,
          f"wide grid: ca_shift {best['ca_shift']} (want {want_ca:.1f})")
    lowered = acquire_refined.lower(
        jnp.asarray(wbits[: ws.block_len], jnp.uint8), ws.code_ffts_p,
        ws.dops_hz, fs=cfg.fs, lo_rate=cfg.lo_rate,
        n_coherent=ws.n_coherent, n_noncoherent=1, dop_chunk=ws.dop_chunk,
        from_bits=True, period=ws.period)
    print(f"  wide grid acquire_refined memory_analysis: "
          f"{lowered.compile().memory_analysis()}", flush=True)
    times["widegrid"] = time_cold_engines(ws, wbits, "wide grid")
    return times


# ----------------------------------------------------------------------
# phase 2
def phase_tracking() -> dict:
    import numpy as np
    import jax
    import jax.numpy as jnp
    from tpu_gnss.config import NOTTINGHAM
    from tpu_gnss.constants import CHIP_RATE_HZ, L1_HZ
    from tpu_gnss.signal import synth
    from tpu_gnss.track import channel as tc

    fs, n_chan, n_epochs, eps = NOTTINGHAM.fs, 12, 400, 10
    p = int(round(fs * 1e-3))
    svs = [synth.SvSignal(prn=1 + (3 * ch) % 32,
                          doppler_hz=-2750.0 + 500.0 * ch,
                          code_phase_chips=37.3 + 83.1 * ch)
           for ch in range(n_chan)]
    prns = [sv.prn for sv in svs]
    iq = jnp.asarray(synth.synth_baseband(svs, fs, n_epochs * p,
                                          noise_std=0.3, seed=0))
    state = tc.init_state(n_chan)
    for ch, sv in enumerate(svs):
        state = tc.start_channel(state, ch, sv.doppler_hz,
                                 sv.code_phase_chips)
    tables = jnp.asarray(tc.channel_code_tables(prns, n_chan))
    spec, nf = tc.code_spectra(prns, n_chan, fs)
    t_s = eps * 1e-3
    kw = dict(fs=fs, pll_gains=tc.second_order_gains(18.0, t_s=t_s),
              dll_gains=tc.second_order_gains(2.0, t_s=t_s),
              epochs_per_step=eps)
    _, out_g = tc.track_epochs(iq, state, tables, **kw)
    _, out_f = tc.track_epochs(iq, state, tables, code_ffts=spec, **kw)

    # tolerance of tests/test_track.py::test_fft_correlator_matches_gather:
    # the FFT taps interpolate the band-limited replica while the gather
    # floor-samples the chips (~1 dB at 5.3 samples/chip), so in lock
    # the mean |prompt I| may sit up to 25 % lower, the prompt signs
    # agree, and both code phases stay within 0.2 chips of truth
    print("  tolerance: mean|ip_fft| > 0.75 mean|ip_gather| over the last "
          "100 epochs, equal prompt sign, |code phase - truth| < 0.2 chips",
          flush=True)
    print(f"  matmul precision: tracking DFT einsums HIGHEST (explicit); "
          f"jax_default_matmul_precision="
          f"{jax.config.jax_default_matmul_precision}", flush=True)
    t = np.arange(n_epochs) * p / fs
    worst = dict(ratio=np.inf, phase_err=0.0)
    for ch, sv in enumerate(svs):
        ip_g = np.asarray(out_g.ip[-100:, ch])
        ip_f = np.asarray(out_f.ip[-100:, ch])
        ratio = np.abs(ip_f).mean() / np.abs(ip_g).mean()
        check(ratio > 0.75, f"ch {ch}: |ip| ratio {ratio:.3f}")
        check(np.sign(ip_f[-1]) == np.sign(ip_g[-1]), f"ch {ch}: sign")
        rate = CHIP_RATE_HZ * (1.0 + sv.doppler_hz / L1_HZ)
        truth = (sv.code_phase_chips + rate * t) % 1023.0
        for out in (out_f, out_g):
            err = (np.asarray(out.code_phase[:, ch]) - truth + 511.5) \
                % 1023.0 - 511.5
            e = float(np.abs(err[-100:]).max())
            check(e < 0.2, f"ch {ch}: code phase error {e:.3f} chips")
            worst["phase_err"] = max(worst["phase_err"], e)
        worst["ratio"] = min(worst["ratio"], float(ratio))
    print(f"  12 channels agree: min |ip| ratio {worst['ratio']:.3f}, "
          f"max code phase error {worst['phase_err']:.4f} chips", flush=True)

    # how far the FFT-dot prompt correlation would move if the DFT
    # einsums ran at DEFAULT precision (TF32 on this card): forward
    # transform of one wiped block both ways, against cuFFT
    n1, _n2, u_rows, f2c, wtc, f1c = tc._dft_tables_np(nf, p)
    blk = iq[:p] * jnp.exp(-2j * jnp.pi * svs[0].doppler_hz
                           * jnp.arange(p) / fs).astype(jnp.complex64)

    @functools.partial(jax.jit, static_argnums=1)
    def four_step(y, prec):
        y = jnp.pad(y, (0, u_rows * n1 - p)).reshape(u_rows, n1)
        z = jnp.einsum("ku,uv->kv", f2c, y, precision=prec)
        g = jnp.einsum("kv,vj->kj", z * wtc, f1c, precision=prec)
        return g.T.reshape(-1)

    ref = jnp.fft.fft(blk, n=nf)
    for name, prec in (("HIGHEST", jax.lax.Precision.HIGHEST),
                       ("DEFAULT", jax.lax.Precision.DEFAULT)):
        fw = four_step(blk, prec)
        spec_err = float(jnp.linalg.norm(fw - ref) / jnp.linalg.norm(ref))
        cp = jnp.sum(fw * spec[0]) / nf
        cp_ref = jnp.sum(ref * spec[0]) / nf
        cp_err = float(jnp.abs(cp - cp_ref) / jnp.abs(cp_ref))
        print(f"  four-step DFT at {name}: spectrum rel err {spec_err:.3e}, "
              f"prompt rel err {cp_err:.3e} (vs jnp.fft.fft)", flush=True)

    # 1 s of signal through the 12-channel einsum bank (information)
    iq1 = jnp.asarray(synth.synth_baseband(svs, fs, 1000 * p,
                                           noise_std=0.3, seed=1))
    run = lambda: jax.block_until_ready(
        tc.track_epochs(iq1, state, tables, code_ffts=spec, **kw))
    run()
    per_s = median_s(run, 5)
    print(f"  12-channel scan wall per second of signal (median of 5): "
          f"{per_s * 1e3:.2f} ms", flush=True)
    return dict(track_wall_per_s=per_s)


# ----------------------------------------------------------------------
# phases 3-4
def scene_files(tmp: str):
    """The e2e tests' 20 s 6-SV scene as a packed 1-bit IF file and an
    int8 interleaved IQ file; returns (fs, rx_truth, bit_path, iq8_path)."""
    import numpy as np
    from tests.test_e2e import FS, build_scene
    from tpu_gnss.io import loaders
    from tpu_gnss.signal.synth import baseband_to_1bit_if
    iq, _ephs, rx = build_scene(duration=20.0, n_sv=6)
    bit_path = os.path.join(tmp, "scene_1bit.bin")
    with open(bit_path, "wb") as f:
        f.write(loaders.pack_1bit(baseband_to_1bit_if(iq, FS / 4, FS)))
    iq8_path = os.path.join(tmp, "scene_iq8.bin")
    scale = 100.0 / max(np.abs(iq.real).max(), np.abs(iq.imag).max())
    raw = np.empty(2 * len(iq), np.int8)
    raw[0::2] = np.clip(np.rint(iq.real * scale), -127, 127)
    raw[1::2] = np.clip(np.rint(iq.imag * scale), -127, 127)
    raw.tofile(iq8_path)
    return FS, np.asarray(rx), bit_path, iq8_path


def run_receiver(cfg, source, rx, mesh=None) -> dict:
    """Receiver.process_source with in-stream solving: fixes, final
    error against scene truth, wall and first-fix seconds."""
    import numpy as np
    from tpu_gnss.receiver import Receiver
    t0 = time.perf_counter()
    first = []
    recv = Receiver(cfg, mesh=mesh)
    res = recv.process_source(
        source, max_channels=12, chunk_s=4.0,
        on_solution=lambda s: first or first.append(time.perf_counter() - t0))
    wall = time.perf_counter() - t0
    check(res.solutions, "no fix")
    s = res.solutions[-1]
    err = float(np.linalg.norm(np.array([s.x, s.y, s.z]) - rx))
    return dict(solutions=res.solutions, err_m=err, wall_s=wall,
                first_fix_s=first[0] if first else None)


def phase_receiver_1bit(fs, rx, bit_path) -> dict:
    from tpu_gnss.config import ReceiverConfig
    from tpu_gnss.io.stream import FileSource1Bit
    cfg = ReceiverConfig(fs=fs, fc=fs / 4, max_fo=5000.0, fft_len=4096,
                         snr_threshold=17.0, num_chans=12)
    out = run_receiver(cfg, FileSource1Bit(bit_path, cfg), rx)
    print(f"  1-bit file: {len(out['solutions'])} fixes, final error "
          f"{out['err_m']:.2f} m (bound 60 m)", flush=True)
    check(out["err_m"] < 60.0, f"1-bit fix error {out['err_m']:.1f} m")
    return out


def phase_receiver_iq8(fs, rx, iq8_path) -> dict:
    from tpu_gnss.config import ReceiverConfig
    from tpu_gnss.io.stream import IQFileSource
    cfg = ReceiverConfig(fs=fs, fc=fs / 4, max_fo=5000.0, fft_len=4096,
                         snr_threshold=20.0, num_chans=12)
    out = run_receiver(cfg, IQFileSource(iq8_path, fs), rx)
    print(f"  int8 IQ file: {len(out['solutions'])} fixes, final error "
          f"{out['err_m']:.2f} m (bound 8 m)", flush=True)
    check(out["err_m"] < 8.0, f"int8 fix error {out['err_m']:.1f} m")
    return out


def phase_four_cards(fs, rx, bit_path) -> None:
    """Phase 3's scene on a 4-card ("dop",) mesh and on one card: the
    fix sequences share snapshot epochs and agree within 1 m."""
    import numpy as np
    from tpu_gnss.config import ReceiverConfig
    from tpu_gnss.dist import shard
    from tpu_gnss.io.stream import FileSource1Bit
    cfg = ReceiverConfig(fs=fs, fc=fs / 4, max_fo=5000.0, fft_len=4096,
                         snr_threshold=17.0, num_chans=12)
    single = run_receiver(cfg, FileSource1Bit(bit_path, cfg), rx)
    mesh = shard.make_mesh(4, axes=("dop",))
    dist = run_receiver(cfg, FileSource1Bit(bit_path, cfg), rx, mesh=mesh)
    ep_s = [s.snap_epoch for s in single["solutions"]]
    ep_d = [s.snap_epoch for s in dist["solutions"]]
    check(ep_d == ep_s, f"snapshot epochs differ: {ep_d} vs {ep_s}")
    worst = max(float(np.linalg.norm([a.x - b.x, a.y - b.y, a.z - b.z]))
                for a, b in zip(dist["solutions"], single["solutions"]))
    print(f"  4-card mesh: {len(ep_d)} fixes at the single-card epochs, "
          f"max deviation {worst:.4f} m (bound 1 m); final error "
          f"{dist['err_m']:.2f} m; wall {dist['wall_s']:.2f} s (one card "
          f"{single['wall_s']:.2f} s)", flush=True)
    check(worst < 1.0, f"mesh fixes deviate by {worst:.3f} m")


# ----------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card mesh receiver and its "
                         "one-card comparison")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    try:
        print(f"card: {card_line()}", flush=True)
        devs = require_gpu()
        need = 4 if args.four_cards else 1
        check(len(devs) >= need, f"{need} GPUs needed, found {len(devs)}")
        print(f"[phase 0] device ok; package third-party imports: "
              f"{sorted(audit_imports() - {'tpu_gnss'})}", flush=True)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            fs, rx, bit_path, iq8_path = scene_files(tmp)
            if args.four_cards:
                print("[phase 4-card] mesh receiver vs one card", flush=True)
                phase_four_cards(fs, rx, bit_path)
            else:
                print("[phase 1] acquisition", flush=True)
                phase_acquisition()
                print("[phase 2] tracking", flush=True)
                phase_tracking()
                print("[phase 3] full receiver, 1-bit IF file", flush=True)
                r1 = phase_receiver_1bit(fs, rx, bit_path)
                print("[phase 4] full receiver, int8 IQ file", flush=True)
                r8 = phase_receiver_iq8(fs, rx, iq8_path)
                print(f"[phase 5] 1-bit: wall {r1['wall_s']:.2f} s, first "
                      f"fix {r1['first_fix_s']} s; int8: wall "
                      f"{r8['wall_s']:.2f} s, first fix {r8['first_fix_s']} "
                      f"s (first runs, compile included)", flush=True)
    except PhaseFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
