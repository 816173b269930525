"""Full-chain demo: 20 s consistent 6-SV scene -> position fix.

Reuses the e2e test's scene builder (light-time-exact code phases,
parity-valid NAV, Doppler-coherent carriers) and runs the COMPLETE
pipeline on the device, reporting wall-clock per stage and the final
position error vs the synthesized truth.  Prints one JSON line.

One process per card: the fresh-process TTFF probes (tools/ttff_probe.py)
run as children BEFORE this process opens the card.
"""
import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import json
import shutil
import subprocess
import tempfile
import time
import numpy as np

from tpu_gnss.utils.jaxcache import enable_persistent_cache
enable_persistent_cache()

from tpu_gnss.config import ReceiverConfig
from tpu_gnss.io import loaders
from tpu_gnss.signal.synth import baseband_to_1bit_if
from tpu_gnss.utils import metrics
import tests.test_e2e as E

# scene synthesis is host-only numpy: the card stays closed until the
# probes below have run
t0 = time.perf_counter()
work = tempfile.mkdtemp(prefix="e2e_payload_")
iq, ephs, rx = E.build_scene()
duration = len(iq) / E.FS
print(f"scene synth: {time.perf_counter()-t0:.1f}s "
      f"({duration:.0f}s of 6-SV baseband at {E.FS/1e6:.3f} Msps)",
      flush=True)

# The HEADLINE path is the reference's actual input format: a 1-bit
# hard-limited IF capture file (c/search_offline.cpp's world).  The
# receiver streams the file's own packed words to the device (1
# bit/sample) and unpacks+mixes there — the analog of the FPGA front end.
fc_if = E.FS / 4
bit_path = os.path.join(work, "e2e_scene_20s_1bit.bin")
with open(bit_path, "wb") as f:
    f.write(loaders.pack_1bit(baseband_to_1bit_if(iq, fc_if, E.FS)))

# The complex-IQ path benches the reference's ACTUAL 8-bit capture
# format (gps_bin1bit_log2bin.m x100-gain int8 IQ output;
# proc_hackrf_bin_for_gps.m input): an int8 interleaved file streamed
# through IQFileSource.
iq8_path = os.path.join(work, "e2e_scene_20s_iq8.bin")
scale = 100.0 / max(np.abs(iq.real).max(), np.abs(iq.imag).max())
raw = np.empty(2 * len(iq), np.int8)
raw[0::2] = np.clip(np.rint(iq.real * scale), -127, 127)
raw[1::2] = np.clip(np.rint(iq.imag * scale), -127, 127)
raw.tofile(iq8_path)
del raw


# Cold TTFF probes in FRESH processes, each alone on the card: the
# first-ever-boot number (empty cache dir -> full trace+compile) as
# ttff_coldcache_s, then two probes on the shared persistent cache (the
# first seeds it, the second runs hot) — the reference's boot-once cost
# model (FPGA bitstream load per power-up, c/main.cpp:14-38).
def run_ttff_probe(env_extra, tag):
    env = dict(os.environ, **env_extra)
    r = subprocess.run(
        [sys.executable, "-u", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "ttff_probe.py"),
         bit_path, str(E.FS)],
        capture_output=True, text=True, timeout=600, env=env)
    line = next((ln for ln in r.stdout.splitlines()
                 if ln.startswith("TTFF_RESULT ")), None)
    if line is None:
        print(f"ttff probe [{tag}] FAILED:\n{r.stdout[-2000:]}\n"
              f"{r.stderr[-2000:]}", flush=True)
        return None
    probe = json.loads(line[len("TTFF_RESULT "):])
    print(f"ttff probe [{tag}]: {probe}", flush=True)
    return probe


with tempfile.TemporaryDirectory(prefix="jaxcache_cold_") as cold_dir:
    probe_cold = run_ttff_probe(
        {"JAX_COMPILATION_CACHE_DIR": cold_dir}, "empty persistent cache")
probe_hot_attempts = [run_ttff_probe({}, f"shared persistent cache #{i}")
                      for i in (1, 2)]
probe_hot = probe_hot_attempts[-1]
if probe_hot is not None:
    probe_hot = dict(probe_hot,
                     attempts=[(p or {}).get("ttff_ctor_s")
                               for p in probe_hot_attempts])

# only now does this process open the card
import jax
from tpu_gnss.io.stream import FileSource1Bit, IQFileSource
from tpu_gnss.receiver import Receiver
print("devices:", jax.devices(), flush=True)

cfg = ReceiverConfig(fs=E.FS, fc=E.FS / 4, max_fo=5000.0, fft_len=4096,
                     snr_threshold=20.0, num_chans=12)
cfg_1bit = ReceiverConfig(fs=E.FS, fc=fc_if, max_fo=5000.0, fft_len=4096,
                          snr_threshold=17.0, num_chans=12)

# run each path twice: the first pass populates the persistent compile
# cache (and in-process jit caches); the second measures steady-state —
# the number that matters for a long-running receiver.  Both passes run
# with in-stream solving so time-to-first-fix is a first-class number:
# ttff_cold_s = process start (receiver construction) -> first fix on a
# cold jit cache; ttff_warm_s = same on the warmed caches.
walls, ttffs, stage_snaps = [], [], []
# pass 0: COLD, in-stream solving -> ttff_cold_s (process start to
#         first fix, jit caches empty beyond the persistent disk cache)
# pass 1: warm, batch mode      -> the headline steady-state realtime
# pass 2: warm, in-stream       -> ttff_warm_s at the live cadence
for attempt, instream in ((0, True), (1, False), (2, True)):
    metrics.METRICS.timings.clear()
    metrics.METRICS.counters.clear()
    t0 = time.perf_counter()
    first_fix = []
    cb = (lambda s: first_fix.append(time.perf_counter() - t0)
          if not first_fix else None) if instream else None
    recv = Receiver(cfg_1bit)
    res = recv.process_source(FileSource1Bit(bit_path, cfg_1bit),
                              max_channels=8, chunk_s=4.0, on_solution=cb)
    walls.append(time.perf_counter() - t0)
    ttffs.append(first_fix[0] if first_fix else None)
    stage_snaps.append({k: round(sum(v), 3)
                        for k, v in metrics.METRICS.timings.items()})
    print(f"1bit pass {attempt} ({'instream' if instream else 'batch'}): "
          f"{walls[-1]:.1f}s wall for {duration:.0f}s "
          f"of capture ({duration/walls[-1]:.2f}x realtime), "
          f"ttff {ttffs[-1] and round(ttffs[-1], 2)}s", flush=True)
    print(f"  stages: {stage_snaps[-1]}", flush=True)
stages_1bit = stage_snaps[1]
wall_headline = walls[1]

# pass 3/4: almanac-DIRECTED warm start (nav/almanac.py) — the cold
# search sweeps only the predicted-visible PRNs (here the scene's six,
# as a stored almanac + last fix would predict) instead of all 32.
# Two passes: the first compiles the subset searcher, the second
# measures; the acquire-stage time is the number to compare.
directed = {}
for attempt in range(2):
    metrics.METRICS.timings.clear()
    metrics.METRICS.counters.clear()
    t0 = time.perf_counter()
    first_fix = []
    recv = Receiver(cfg_1bit)
    res_d = recv.process_source(
        FileSource1Bit(bit_path, cfg_1bit), max_channels=8, chunk_s=4.0,
        search_prns=[2, 3, 4, 5, 6, 7],
        on_solution=(lambda s: first_fix.append(time.perf_counter() - t0)
                     if not first_fix else None))
    wall_d = time.perf_counter() - t0
    directed = dict(
        wall_s=round(wall_d, 2),
        realtime=round(duration / wall_d, 2),
        ttff_s=round(first_fix[0], 2) if first_fix else None,
        n_prns_swept=6,
        acquire_s=round(sum(metrics.METRICS.timings.get(
            "receiver.acquire", [])), 3),
        n_solutions=len(res_d.solutions))
    print(f"1bit directed pass {attempt}: {directed}", flush=True)
directed["acquire_s_fullsweep"] = stages_1bit.get("receiver.acquire")


iq_results = {}
# the chunk_s=8 int4 row is a fixed-cost probe: if the path were purely
# link-bound, halving the bytes (int4 vs int8) would ~double realtime;
# it doesn't, so per-chunk fixed costs bind — doubling the chunk halves
# the per-chunk count and exposes how much of the floor they are.
# int2 is the 2-bit sign/magnitude GNSS-ADC link mode (4 components/
# byte — half of int4's traffic, ~0.55 dB quantization budget).
for label, dtype, ch_s in (("int8", "int8", 4.0), ("int4", "int4", 4.0),
                           ("int2", "int2", 4.0),
                           ("int4_chunk8", "int4", 8.0)):
    walls_iq = []
    for attempt in range(2):
        recv = Receiver(cfg, transfer_dtype=dtype)
        metrics.METRICS.timings.clear()
        metrics.METRICS.counters.clear()
        t0 = time.perf_counter()
        res_iq = recv.process_source(IQFileSource(iq8_path, E.FS),
                                     max_channels=8, chunk_s=ch_s)
        walls_iq.append(time.perf_counter() - t0)
        print(f"iq[{label}] pass {attempt}: {walls_iq[-1]:.1f}s wall for "
              f"{duration:.0f}s ({duration/walls_iq[-1]:.2f}x realtime)",
              flush=True)
    err_iq = None
    if res_iq.solutions:
        s = res_iq.solutions[-1]
        err_iq = round(float(np.linalg.norm(
            np.array([s.x, s.y, s.z]) - rx)), 1)
    iq_results[label] = dict(
        wall_s=round(walls_iq[-1], 2),
        realtime=round(duration / walls_iq[-1], 2),
        detections=[(d["prn"], round(d["snr"])) for d in res_iq.detections],
        n_solutions=len(res_iq.solutions), fix_error_m=err_iq,
        stages={k: round(sum(v), 3)
                for k, v in metrics.METRICS.timings.items()})
    print(f"iq[{label}]: {iq_results[label]}", flush=True)
walls_iq = [iq_results["int8"]["wall_s"]]

wall = wall_headline
print(f"detections: {[(d['prn'], round(d['snr'])) for d in res.detections]}")
print(f"solutions: {len(res.solutions)}")
err = None
if res.solutions:
    s = res.solutions[-1]
    err = float(np.linalg.norm(np.array([s.x, s.y, s.z]) - rx))
    print(f"final fix error: {err:.1f} m  "
          f"(lat {s.lat_deg:.5f} lon {s.lon_deg:.5f} alt {s.alt_m:.0f})")
print(metrics.METRICS.report())

artifact = dict(metric="e2e_realtime_factor",
                value=round(duration / wall, 2), unit="x_realtime",
                wall_s=round(wall, 2), capture_s=duration,
                cold_wall_s=round(walls[0], 2),
                # ttff_cold_s: FRESH process, hot persistent compile
                # cache (boot-once model; tools/ttff_probe.py),
                # receiver construction -> first fix (the round-4
                # convention; the _detail dicts also carry ttff_s from
                # true process start incl. jax import).
                # ttff_coldcache_s: same probe with an EMPTY cache dir
                # (first-ever boot, full compile).
                # ttff_inprocess_pass0_s: this process's first pass
                # (cache state = whatever the host had).
                ttff_cold_s=(probe_hot or {}).get("ttff_ctor_s"),
                ttff_cold_detail=probe_hot,
                ttff_coldcache_s=(probe_cold or {}).get("ttff_ctor_s"),
                ttff_coldcache_detail=probe_cold,
                ttff_inprocess_pass0_s=(round(ttffs[0], 2)
                                        if ttffs[0] is not None else None),
                ttff_warm_s=(round(ttffs[-1], 2)
                             if ttffs[-1] is not None else None),
                instream_wall_s=round(walls[-1], 2),
                stages_cold=stage_snaps[0],
                input="1bit_if_file_packed_uplink",
                iq_path_realtime_factor=iq_results["int8"]["realtime"],
                iq_path_wall_s=iq_results["int8"]["wall_s"],
                iq_path_int4_realtime_factor=iq_results["int4"]["realtime"],
                iq_paths=iq_results,
                directed_search=directed,
                n_solutions=len(res.solutions),
                final_fix_error_m=round(err, 1) if err is not None else None,
                stages=stages_1bit)
shutil.rmtree(work, ignore_errors=True)
print(json.dumps(artifact))
print("PAYLOAD_DONE")
