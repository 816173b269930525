"""Live-personality bench on the device: follow a 1x-realtime writer.

A writer thread paces the 60 s soak capture into a growing file at
exactly 1x realtime (the rig's sampling rate); the receiver tails it
with FollowSource1Bit and solves IN-STREAM.  Reported per fix: delivery
latency behind the RF timeline (wall clock at delivery minus the
snapshot's scene time) — the end-to-end latency a live operator sees,
which the reference cannot even instrument.  Also: worst reader lag
behind the write frontier and the stall/EOF status.  The capture comes
from a CPU-only child (tools/soak_scene_gen.py, the soak scene), so this
process is the only one on the card.  Prints one JSON line.
"""
import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import json
import subprocess
import tempfile
import threading
import time

import numpy as np

from tpu_gnss.utils.jaxcache import enable_persistent_cache
enable_persistent_cache()

from tpu_gnss.config import ReceiverConfig
from tpu_gnss.io.stream import FollowSource1Bit
from tpu_gnss.receiver import Receiver
import tests.test_e2e as E

DURATION = float(os.environ.get("LIVE_DURATION_S", "60"))
TMP = tempfile.gettempdir()
src_path = os.path.join(TMP, f"soak_1bit_{int(DURATION)}.bin")
if not os.path.exists(src_path + ".rx.npy"):
    # the soak scene (SV index 0 blocked over [20, 28) s), generated by a
    # CPU-only child before this process opens the card
    gen = subprocess.run(
        [sys.executable, "-u", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "soak_scene_gen.py"),
         src_path, str(DURATION), "0", "20.0", "28.0"],
        capture_output=True, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert gen.returncode == 0, gen.stderr[-2000:]
rx = np.load(src_path + ".rx.npy")
payload = open(src_path, "rb").read()

fc = E.FS / 4
cfg = ReceiverConfig(fs=E.FS, fc=fc, max_fo=5000.0, fft_len=4096,
                     snr_threshold=17.0, num_chans=12)

# warm pass on a static copy: compile caches + jit traces — for BOTH
# chunk shapes the timed phases use (the main phase's 1.0 s and the
# warm-start phase's 0.5 s; a chunk shape traces its own tracker
# program, and an untraced shape makes the warm-start phase pay a
# multi-second compile catch-up it then reports as fix latency)
warm_path = os.path.join(TMP, "live_warm.bin")
open(warm_path, "wb").write(payload[: len(payload) // 4])
open(warm_path + ".done", "w").close()
recv = Receiver(cfg)
recv.process_source(FollowSource1Bit(warm_path, cfg), chunk_s=1.0,
                    on_solution=lambda s: None)
Receiver(cfg).process_source(FollowSource1Bit(warm_path, cfg),
                             chunk_s=0.5, max_duration_s=8.0,
                             on_solution=lambda s: None)
print("warm pass done", flush=True)
# a fresh source digest re-exports every program in background threads
# (~1-3 s of GIL-heavy tracing each) — let them land BEFORE the timed
# realtime phases, or they starve the live loop for seconds
from tpu_gnss.utils import progcache
progcache.wait_exports(timeout=120.0)
print("exports settled", flush=True)

live_path = os.path.join(TMP, "live_feed.bin")
for p in (live_path, live_path + ".done"):
    if os.path.exists(p):
        os.remove(p)
open(live_path, "wb").close()

bytes_per_s = int(E.FS) // 8
t_start = None


def writer():
    """Pace the capture at exactly 1x realtime, 100 ms slices."""
    slice_b = bytes_per_s // 10
    with open(live_path, "ab") as f:
        for i in range(0, len(payload), slice_b):
            target = t_start + (i / bytes_per_s)
            now = time.perf_counter()
            if target > now:
                time.sleep(target - now)
            f.write(payload[i: i + slice_b])
            f.flush()
    open(live_path + ".done", "w").close()


fixes = []


def on_fix(s):
    t_wall = time.perf_counter() - t_start
    fixes.append(dict(snap_s=s.snap_epoch / 1000.0,
                      wall_s=round(t_wall, 3),
                      latency_s=round(t_wall - s.snap_epoch / 1000.0, 3),
                      err_m=round(float(np.linalg.norm(
                          np.array([s.x, s.y, s.z]) - rx)), 2)))
    print(f"[fix] scene t={fixes[-1]['snap_s']:.1f}s delivered at "
          f"wall {t_wall:.1f}s (latency {fixes[-1]['latency_s']:.2f}s, "
          f"err {fixes[-1]['err_m']} m)", flush=True)


src = FollowSource1Bit(live_path, cfg, stall_timeout_s=10.0, poll_s=0.01)
# bounded history: the live default (trimming + anchor archive)
recv = Receiver(cfg, max_history_s=float(
    os.environ.get("LIVE_MAX_HISTORY_S", "600")))
t_start = time.perf_counter()
th = threading.Thread(target=writer)
th.start()
res = recv.process_source(src, max_channels=12, chunk_s=1.0,
                          on_solution=on_fix)
wall = time.perf_counter() - t_start
th.join()

# Live fixes = delivered promptly by the in-stream solver.  Snapshot
# epochs EARLIER than ephemeris-decode completion (~scene t<20 s on a
# cold start) are unsolvable live — no ephemeris existed yet — and are
# recovered retroactively by the end pass with latency ~= stream
# length; that is correct cold-start physics, reported separately.
instream = [f for f in fixes if f["latency_s"] < 10.0]
retro = [f for f in fixes if f["latency_s"] >= 10.0]
lat = [f["latency_s"] for f in instream]
# every 4 s slot AFTER the first live fix must have been served live
first_live = min(f["snap_s"] for f in instream) if instream else None
expected_live = ([t for t in np.arange(4.0, DURATION, 4.0)
                  if t >= first_live] if first_live is not None else [])
served = {f["snap_s"] for f in instream}
missed = [t for t in expected_live if t not in served]
ok = (not src.stalled and len(instream) >= 10 and not missed
      and max(f["err_m"] for f in fixes) < 50.0
      and max(lat) < 6.0)
artifact = dict(metric="live_fix_latency_s",
                value=round(float(np.median(lat)), 2) if lat else None,
                unit="s_behind_rf_timeline",
                capture_s=DURATION, wall_s=round(wall, 2),
                n_fixes_live=len(instream),
                n_fixes_retroactive=len(retro),
                first_live_fix_scene_s=first_live,
                missed_live_slots=missed,
                max_latency_s=max(lat) if lat else None,
                worst_err_m=max(f["err_m"] for f in fixes)
                if fixes else None,
                reader_max_lag_s=round(src.max_lag_s, 3),
                stalled=bool(src.stalled),
                fixes=instream,
                passed=bool(ok))
# ---- warm-start phase: checkpointed ephemerides (utils.checkpoint
# analog) collapse time-to-first-live-fix from ~20 s (three subframes)
# to one subframe: pace the first 24 s of the capture again, warm
from tests.test_pvt import make_constellation
ephs = make_constellation(6, t_oe=E.T_OE)
warm = {E.eph_prn(k): e for k, e in enumerate(ephs)}

warm_live = os.path.join(TMP, "live_feed_warm.bin")
for p in (warm_live, warm_live + ".done"):
    if os.path.exists(p):
        os.remove(p)
open(warm_live, "wb").close()
# 36 s at 0.5 s chunks: (a) warm+HOW-anchored first fix (one TOW from a
# preamble+HOW pair suffices — no full subframe wait), (b) the latency
# FLOOR at half the main phase's chunk size (the round-3 open question:
# how much of the 1.95 s median is the 1 s chunk itself)
WARM_S = 36.0
WARM_CHUNK_S = 0.5
warm_payload = payload[: int(WARM_S * bytes_per_s)]


def warm_writer():
    slice_b = bytes_per_s // 10
    with open(warm_live, "ab") as f:
        for i in range(0, len(warm_payload), slice_b):
            target = t_start + (i / bytes_per_s)
            now = time.perf_counter()
            if target > now:
                time.sleep(target - now)
            f.write(warm_payload[i: i + slice_b])
            f.flush()
    open(warm_live + ".done", "w").close()


warm_fixes = []


def on_warm_fix(s):
    t_wall = time.perf_counter() - t_start
    warm_fixes.append(dict(snap_s=s.snap_epoch / 1000.0,
                           wall_s=round(t_wall, 3),
                           latency_s=round(t_wall - s.snap_epoch / 1000.0,
                                           3)))
    print(f"[warm fix] scene t={warm_fixes[-1]['snap_s']:.1f}s at wall "
          f"{t_wall:.1f}s", flush=True)


src_w = FollowSource1Bit(warm_live, cfg, stall_timeout_s=10.0, poll_s=0.01)
recv = Receiver(cfg)
t_start = time.perf_counter()
th = threading.Thread(target=warm_writer)
th.start()
recv.process_source(src_w, max_channels=12, chunk_s=WARM_CHUNK_S,
                    warm_ephemerides=warm, on_solution=on_warm_fix)
th.join()
warm_instream = [f for f in warm_fixes if f["latency_s"] < 10.0]
first_warm = (min(f["wall_s"] for f in warm_instream)
              if warm_instream else None)
warm_lat = [f["latency_s"] for f in warm_instream]
artifact["warm_start_first_live_fix_wall_s"] = first_warm
artifact["warm_chunk_s"] = WARM_CHUNK_S
artifact["warm_median_latency_s"] = (round(float(np.median(warm_lat)), 2)
                                     if warm_lat else None)
artifact["passed"] = bool(ok and first_warm is not None
                          and first_warm <= 6.0)
print(f"warm start: first live fix at wall {first_warm}s "
      f"(cold needed ~{artifact['first_live_fix_scene_s']}s); "
      f"median latency at chunk_s={WARM_CHUNK_S}: "
      f"{artifact['warm_median_latency_s']}s", flush=True)

print(json.dumps({k: v for k, v in artifact.items() if k != "fixes"}))
print("PAYLOAD_DONE" if artifact["passed"] else "PAYLOAD_FAILED")
