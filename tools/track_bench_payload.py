"""Tracking-bank throughput on the device at 12, 32 and 64 channels.

Times the einsum FFT-dot tracking correlator (tpu_gnss/track/channel.py)
at the reference's 12 channels and beyond (the reference is capped at 12
by Spartan-3 fabric, "Homemade GPS Receiver.html":57,95; one FPGA = 1x
realtime).  Each run tracks 1 s of 5.456 Msps baseband; the per-second
cost is the median of 5 timed runs ending in ``block_until_ready``.
Prints one JSON line.
"""
import sys, os; sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import json
import time

import numpy as np

from tpu_gnss.utils.jaxcache import enable_persistent_cache
enable_persistent_cache()

import jax
import jax.numpy as jnp

from tpu_gnss.track import channel as tc
from tpu_gnss.signal import synth
from tpu_gnss.utils.xfer import to_device_complex

FS = 5.456e6
E = 10                       # epochs per scan step (10 ms)
ALL_PRNS = list(range(1, 33))


def bench_bank(n_chan: int) -> dict:
    prns = [ALL_PRNS[i % 32] for i in range(n_chan)]
    # synthesize 12 distinct SVs and reuse the mixture for bigger banks:
    # correlator cost does not depend on how many SVs are really present
    svs = [synth.SvSignal(prn=p, doppler_hz=250.0 * i - 1500.0,
                          code_phase_chips=80.0 * i)
           for i, p in enumerate(prns[:12])]
    iq = synth.synth_baseband(svs, FS, 1000 * 5456, noise_std=0.5, seed=7)
    iq_d = to_device_complex(iq)
    state0 = tc.init_state(n_chan)
    for ch, p in enumerate(prns):
        state0 = tc.start_channel(state0, ch, 250.0 * (ch % 12) - 1500.0,
                                  80.0 * (ch % 12))
    tables = jnp.asarray(tc.channel_code_tables(prns, n_chan))
    spec, _nf = tc.code_spectra(prns, n_chan, FS)
    g1 = tc.second_order_gains(18.0, t_s=E * 1e-3)
    g2 = tc.second_order_gains(2.0, t_s=E * 1e-3)

    def run():
        return jax.block_until_ready(tc.track_epochs(
            iq_d, state0, tables, fs=FS, pll_gains=g1, dll_gains=g2,
            epochs_per_step=E, code_ffts=spec))

    _, out = run()                         # compile + settle
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    dt = sorted(times)[2]
    lock = float(np.abs(np.asarray(out.ip[-50:, 0])).mean())
    rt = 1.0 / dt                # each run tracks 1 s of samples
    print(f"n_chan={n_chan:3d}: {dt*1e3:7.2f} ms/s -> {rt:7.1f}x realtime "
          f"lock|ip|~{lock:.0f}", flush=True)
    return dict(n_chan=n_chan, realtime_factor=rt, ms_per_s=dt * 1e3,
                lock_ip=lock)


dev = jax.devices()[0]
sweep = [bench_bank(n) for n in (12, 32, 64)]
print(json.dumps(dict(metric="tracking_realtime_factor",
                      value=sweep[0]["realtime_factor"], unit="x_realtime",
                      n_chan=12, fs_hz=FS, epochs_per_step=E, sweep=sweep,
                      platform=dev.platform, device_kind=dev.device_kind)))
