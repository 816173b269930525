"""Long-capture soak on real hardware: 60 s 1-bit stream, bounded memory.

Streams a >= 60 s 1-bit IF capture (with a mid-run SV blockage) through
the COMPLETE chain on the device — acquisition, tracking, watchdog,
re-acquisition, NAV decode, 4 s PVT cadence — and reports wall clock,
peak RSS, fix cadence coverage, and worst-case fix error.  The
continuous-operation property of the reference's live rig
(c/solve.cpp:300; c/channel.cpp:211-254 SignalLost) as one artifact.

Shares the scene recipe with tests/test_soak.py (the CI-sized variant).
The scene is generated by a CPU-only child (tools/soak_scene_gen.py), so
this process is the only one on the card.  Prints one JSON line.
"""
import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import json
import resource
import tempfile
import time

import numpy as np

from tpu_gnss.utils.jaxcache import enable_persistent_cache
enable_persistent_cache()

# fail fast if the device is unreachable, before scene synthesis
import jax, jax.numpy as jnp
_t0 = time.perf_counter()
print("alive:", np.asarray(jnp.arange(2) + 1),
      f"({time.perf_counter()-_t0:.1f}s)", flush=True)

from tpu_gnss.config import ReceiverConfig
from tpu_gnss.io.stream import FileSource1Bit
from tpu_gnss.receiver import Receiver
from tpu_gnss.utils import metrics
import tests.test_e2e as E

DURATION = float(os.environ.get("SOAK_DURATION_S", "60"))
DROP_SV, DROP_T0, DROP_T1 = 0, 20.0, 28.0

rss0_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
t0 = time.perf_counter()
fc = E.FS / 4
path = os.path.join(tempfile.gettempdir(), f"soak_1bit_{int(DURATION)}.bin")
rx_path = path + ".rx.npy"
if not (os.path.exists(path) and os.path.exists(rx_path)):
    # fixture generation runs in a SUBPROCESS so this process's peak
    # RSS (the artifact) measures the RECEIVER, not scene synthesis
    import subprocess
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    gen = subprocess.run(
        [sys.executable, "-u", os.path.join(repo, "tools",
                                            "soak_scene_gen.py"),
         path, str(DURATION), str(DROP_SV), str(DROP_T0), str(DROP_T1)],
        capture_output=True, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert gen.returncode == 0, gen.stderr[-2000:]
    print(gen.stdout.strip(), flush=True)
rx = np.load(rx_path)
rss_synth_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
print(f"scene synth + 1-bit pack: {time.perf_counter()-t0:.1f}s "
      f"({DURATION:.0f}s of 6-SV IF at {E.FS/1e6:.3f} Msps, "
      f"{os.path.getsize(path)/1e6:.1f} MB packed, dropout SV idx "
      f"{DROP_SV} over [{DROP_T0},{DROP_T1})s)", flush=True)

cfg = ReceiverConfig(fs=E.FS, fc=fc, max_fo=5000.0, fft_len=4096,
                     snr_threshold=17.0, num_chans=12)

walls = []
for attempt in range(2):   # pass 0 warms the compile caches
    recv = Receiver(cfg)
    metrics.METRICS.timings.clear()
    metrics.METRICS.counters.clear()
    t0 = time.perf_counter()
    res = recv.process_source(FileSource1Bit(path, cfg), chunk_s=1.0)
    walls.append(time.perf_counter() - t0)
    print(f"pass {attempt}: {walls[-1]:.1f}s wall for {DURATION:.0f}s "
          f"({DURATION/walls[-1]:.2f}x realtime)", flush=True)
    if attempt == 0:
        # background program exports (fresh digest) must not contend
        # with the timed pass
        from tpu_gnss.utils import progcache
        progcache.wait_exports(timeout=120.0)
wall = walls[-1]
rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0

prn = E.eph_prn(DROP_SV)
drop_recs = [r for r in res.channels if r.prn == prn]
reacquired = len(drop_recs) >= 2 and drop_recs[0].lost
snap_s = [s.snap_epoch * 1e-3 for s in res.solutions]
first_fix = snap_s[0] if snap_s else None
expected = ([t for t in np.arange(4.0, DURATION - 1.0, 4.0)
             if t >= first_fix] if first_fix is not None else [])
missing = sorted(set(np.round(expected, 3)) - set(np.round(snap_s, 3)))
errs = [float(np.linalg.norm(np.array([s.x, s.y, s.z]) - rx))
        for s in res.solutions]
hist_mb = sum(arr.nbytes for r in res.channels
              for parts in r._chunks.values() for arr in parts) / 1e6

print(f"fixes: {len(res.solutions)} (first at {first_fix}s, "
      f"missed slots: {missing or 'none'})")
print(f"dropout PRN {prn}: lost={drop_recs[0].lost if drop_recs else None} "
      f"re-acquired={reacquired}")
if errs:
    print(f"fix error: worst {max(errs):.1f} m, final {errs[-1]:.1f} m")
print(f"memory: peak RSS {rss_mb:.0f} MB (start {rss0_mb:.0f}), "
      f"retained histories {hist_mb:.2f} MB")
print(metrics.METRICS.report())

# Per-fix diagnostics for error-growth attribution (VERDICT r3 #7):
# the error time series (trend vs spike), the solver's post-fit
# residual, satellite count, and the channels' anchor ages at each
# snapshot — enough to tell drifting pseudoranges (systematic, grows
# with time) from isolated bad epochs (geometry/outlier).
fix_series = []
for s, e in zip(res.solutions, errs):
    ages = []
    for r in res.channels:
        anchors = [a for a in (r.archived_subframes + r.subframes)
                   if a.get("bit_epoch") is not None
                   and a["bit_epoch"] + r.start_epoch < s.snap_epoch]
        if anchors and not r.lost:
            newest = max(a["bit_epoch"] + r.start_epoch for a in anchors)
            ages.append(round((s.snap_epoch - newest) * 1e-3, 1))
    _resid = getattr(s, "residual_rms_m", None)
    fix_series.append(dict(
        t_s=round(s.snap_epoch * 1e-3, 1), err_m=round(e, 2),
        resid_m=round(float(_resid), 2) if _resid is not None else None,
        n_sats=len(getattr(s, "sats", []) or []),
        anchor_age_max_s=max(ages) if ages else None))

# r4 regression lock (VERDICT r3 #7): flat error profile with
# soft-RAIM exclusion — worst fix must stay < 4 m (measured 2.2 m
# over 300 s, median 1.45 m)
ok = (reacquired and not missing and errs and max(errs) < 4.0
      and first_fix is not None and first_fix <= 8.0)
artifact = dict(metric="soak_realtime_factor",
                value=round(DURATION / wall, 2), unit="x_realtime",
                capture_s=DURATION, wall_s=round(wall, 2),
                cold_wall_s=round(walls[0], 2),
                n_fixes=len(res.solutions),
                first_fix_s=first_fix, missed_fix_slots=missing,
                reacquired_after_dropout=bool(reacquired),
                worst_fix_error_m=round(max(errs), 1) if errs else None,
                peak_rss_mb=round(rss_mb),
                rss_after_scene_synth_mb=round(rss_synth_mb),
                hist_mb=round(hist_mb, 2),
                fix_series=fix_series,
                passed=bool(ok))
print(json.dumps(artifact))
print("PAYLOAD_DONE" if ok else "PAYLOAD_FAILED")
