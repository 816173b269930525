"""Multi-host (multi-process) execution: DCN collectives + per-host feeding.

The reference's entire inter-processor transport is the 16-opcode SPI
command link between the Pi and the FPGA (reference: c/spi.cpp:34-53;
atomic snapshot spi_hog :73-80).  SURVEY §2.5 maps it to jax collectives
across devices *and hosts*: this module is the multi-host half — a `jax.distributed`
runner, a process-spanning mesh, and per-host capture feeding where each
host uploads only its local shard of the capture blocks.

Design: the single-process sharded engines in :mod:`tpu_gnss.dist.shard`
are already written against a mesh + global arrays, so multi-host reuses
them unchanged; what this module adds is (1) process bring-up, (2) the
host-local -> global array assembly (`jax.make_array_from_process_local_data`)
for the block axis, and (3) result gathering back to every host
(`multihost_utils.process_allgather` — the solver-snapshot analog of the
reference's spi_hog atomic clock capture).

Testing without a pod (SURVEY §4(c) "multi-host tests via N-process
simulation"): ``initialize(..., cpu_devices=k)`` forces the CPU backend
with gloo cross-process collectives, so N local processes x k virtual
devices emulate N hosts.  ``python -m tpu_gnss.dist.multihost`` is the
worker entry point used by tests/test_multihost.py and
tools/bench_dist.py --multiprocess.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def initialize(coordinator: str, num_processes: int, process_id: int,
               cpu_devices: Optional[int] = None) -> None:
    """Bring up `jax.distributed` for this process.

    Must run before any jax backend initializes.  ``cpu_devices`` forces
    the CPU backend with that many virtual devices per process and gloo
    cross-process collectives — the podless N-process simulation mode.
    With ``cpu_devices=None`` the ambient platform (e.g. the GPUs of
    each host) is used as-is.
    """
    if cpu_devices is not None:
        os.environ["JAX_PLATFORMS"] = "cpu"
        # force (replace, not append) the virtual device count: a parent
        # test process may already carry its own 8-device flag
        flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
                 if "host_platform_device_count" not in f]
        flags.append(
            f"--xla_force_host_platform_device_count={cpu_devices}")
        os.environ["XLA_FLAGS"] = " ".join(flags)
    import jax
    if cpu_devices is not None:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


def global_mesh(axes: Sequence[str], shape: Optional[Sequence[int]] = None):
    """Mesh over ALL processes' devices (process-major device order).

    Process-major ordering means the first mesh axis groups whole hosts
    when its extent is a multiple of the process count — lay the
    block/data axis there so its collectives ride DCN once per step
    while inner axes stay intra-host.
    """
    import jax
    from jax.sharding import Mesh
    devs = jax.devices()
    if shape is None:
        assert len(axes) == 1
        shape = (len(devs),)
    assert int(np.prod(shape)) == len(devs), (shape, len(devs))
    return Mesh(np.asarray(devs).reshape(shape), tuple(axes))


def feed_local_blocks(blocks_local: np.ndarray, mesh, axis: str = "blk"):
    """Per-host capture feeding: local block slice -> global device array.

    Each process passes only ITS contiguous slice of the global block
    batch (process p holds blocks [p*B_local, (p+1)*B_local)); the
    result is one global array sharded over ``axis`` that the
    shard-mapped engines consume.  No host ever touches another host's
    samples — the multi-host capture feed SURVEY §2.5 requires.
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    sharding = NamedSharding(mesh, P(axis))
    return jax.make_array_from_process_local_data(sharding, blocks_local)


def gather_to_hosts(tree):
    """Fetch a (possibly sharded) result pytree to every host as numpy.

    The cross-host snapshot assembly — the DCN analog of the solver's
    atomic spi_hog clock capture (reference: c/solve.cpp:62-85).
    """
    from jax.experimental import multihost_utils
    return multihost_utils.process_allgather(tree, tiled=True)


def acquire_blocks_multihost(bits_local: np.ndarray, code_ffts,
                             dops: np.ndarray, *, mesh, lo_rate: float,
                             lags: int, dop_chunk: int = 16):
    """Multi-host block+Doppler sharded acquisition, results on all hosts.

    ``bits_local``: this host's ``[B_local, fft_len]`` slice of the
    global block batch.  Returns numpy arrays ``[B_global, n_sv]``
    (snr, lo_shift, ca_shift), identical on every host and identical to
    the single-process engine on the full batch.
    """
    import jax.numpy as jnp
    from .shard import acquire_blocks_sharded
    blocks = feed_local_blocks(bits_local, mesh, "blk")
    res = acquire_blocks_sharded(blocks, code_ffts, jnp.asarray(dops),
                                 mesh=mesh, lo_rate=lo_rate, lags=lags,
                                 dop_chunk=dop_chunk)
    g = gather_to_hosts(res)
    return np.asarray(g.snr), np.asarray(g.lo_shift), np.asarray(g.ca_shift)


def track_epochs_multihost(iq: np.ndarray, state_local, tables_local, *,
                           mesh, axis: str = "chan", fs: float,
                           pll_gains, dll_gains):
    """Multi-host channel-parallel tracking; outputs gathered to all hosts.

    The 12-FPGA-channel bank (reference: c/gps.h:17) sharded ACROSS
    PROCESSES: each host feeds only its local slice of the channel state
    and code tables (``state_local`` leaves ``[n_chan_local, ...]``),
    the shared 1 ms sample stream is replicated (it is small — the
    integrate-and-dump reduction has not happened yet but one chunk is
    ~MB), and every host receives the full per-epoch output bank —
    per-host output gathering, the DCN analog of the solver reading all
    channels over SPI (reference: c/solve.cpp:62-85).
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from .shard import track_epochs_sharded

    rep = NamedSharding(mesh, P())
    shard_ch = NamedSharding(mesh, P(axis))
    iq_g = jax.make_array_from_process_local_data(rep, np.asarray(iq))
    state_g = jax.tree.map(
        lambda x: jax.make_array_from_process_local_data(
            shard_ch, np.asarray(x)), state_local)
    tables_g = jax.make_array_from_process_local_data(
        shard_ch, np.asarray(tables_local))
    st2, out = track_epochs_sharded(iq_g, state_g, tables_g, mesh=mesh,
                                    axis=axis, fs=fs,
                                    pll_gains=pll_gains,
                                    dll_gains=dll_gains)
    return gather_to_hosts(st2), gather_to_hosts(out)


# ----------------------------------------------------------------------
def _worker(argv=None) -> int:
    """Subprocess worker for the N-process simulation (tests + bench).

    Every process generates the SAME deterministic global block batch,
    keeps only its local slice, runs the mesh engines, and dumps the
    gathered global results — so the test can assert (a) all processes
    agree and (b) they equal the single-process engine.
    """
    import argparse
    p = argparse.ArgumentParser(prog="multihost_worker")
    p.add_argument("--coordinator", default="127.0.0.1:9955")
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--cpu-devices", type=int, default=2)
    p.add_argument("--out", required=True, help="npz path for results")
    p.add_argument("--blocks-per-dev", type=int, default=2)
    p.add_argument("--bench-repeats", type=int, default=0,
                   help="also time the sharded engine (bench mode)")
    p.add_argument("--flagship", action="store_true",
                   help="run at the reference capture's real shapes "
                        "(Nottingham: fs=5.456e6, 40000-pt FFT, 136 Hz "
                        "Doppler bins, 73-bin grid) instead of the tiny "
                        "test config")
    args = p.parse_args(argv)

    initialize(args.coordinator, args.num_processes, args.process_id,
               cpu_devices=args.cpu_devices)
    import jax
    import jax.numpy as jnp
    from ..config import ReceiverConfig
    from ..acquire.search import Searcher
    from .shard import pad_dops

    n_total = args.num_processes * args.cpu_devices
    # mesh: blk axis spans processes (outer), dop axis intra-process
    mesh = global_mesh(("blk", "dop"), (args.num_processes,
                                        args.cpu_devices))
    if args.flagship:
        # the reference gps_test's own geometry (SURVEY §6 golden table:
        # fs=5.456 MHz, IF=4.092 MHz, 40000-pt window, bin=fs/40000)
        cfg = ReceiverConfig(fs=5.456e6, fc=4.092e6, max_fo=5000.0,
                             fft_len=40000)
        dop_chunk = 8
    else:
        cfg = ReceiverConfig(fs=1.024e6, fc=0.256e6, max_fo=5000.0,
                             fft_len=2048)
        dop_chunk = 2
    searcher = Searcher(cfg, dop_chunk=dop_chunk)
    dops = pad_dops(np.arange(-cfg.dop_max_bin, cfg.dop_max_bin + 1,
                              dtype=np.int32), args.cpu_devices, dop_chunk)

    n_blk = args.num_processes * args.blocks_per_dev
    rng = np.random.default_rng(7)
    bits_all = rng.integers(0, 2, (n_blk, cfg.fft_len), dtype=np.uint8)
    per = n_blk // args.num_processes
    lo = args.process_id * per
    bits_local = bits_all[lo: lo + per]

    snr, lo_shift, ca_shift = acquire_blocks_multihost(
        bits_local, searcher.code_ffts, dops, mesh=mesh,
        lo_rate=cfg.lo_rate, lags=cfg.lags, dop_chunk=dop_chunk)

    wall = None
    if args.bench_repeats:
        import time
        t0 = time.perf_counter()
        for _ in range(args.bench_repeats):
            acquire_blocks_multihost(
                bits_local, searcher.code_ffts, dops, mesh=mesh,
                lo_rate=cfg.lo_rate, lags=cfg.lags, dop_chunk=dop_chunk)
        wall = (time.perf_counter() - t0) / args.bench_repeats

    # --- multi-host channel-parallel TRACKING on a real multi-SV
    # baseband: every process synthesizes the same deterministic scene,
    # slices its local channels, and must gather the full locked bank
    from ..track import channel as tc
    from ..signal import synth
    # channel count adapts to the topology: a multiple of the device
    # count (track_epochs_sharded's requirement) and of the process
    # count (equal per-host state slices); 8 channels at the standard
    # test sizes, scaled up when devices outnumber them
    n_chan = n_total * max(1, 8 // n_total)
    if args.flagship:
        n_chan = max(n_chan, 2 * n_total)   # >= 16 channels at 4x2
    mesh_ch = global_mesh(("chan",), (n_total,))
    p_len = round(cfg.fs * 1e-3)
    n_epochs = 200 if args.flagship else 40
    svs = [synth.SvSignal(prn=1 + (3 * ch) % 32,
                          doppler_hz=500.0 * (ch % 5) - 1000.0,
                          code_phase_chips=61.0 * ch % 1023.0)
           for ch in range(n_chan)]
    iq_scene = synth.synth_baseband(svs, cfg.fs, n_epochs * p_len,
                                    noise_std=0.3, seed=5)
    state = tc.init_state(n_chan)
    for ch, sv in enumerate(svs):
        state = tc.start_channel(state, ch, sv.doppler_hz,
                                 sv.code_phase_chips)
    tables = np.asarray(tc.channel_code_tables(
        [sv.prn for sv in svs], n_chan))
    per_ch = n_chan // args.num_processes
    lo_ch = args.process_id * per_ch
    state_local = jax.tree.map(
        lambda x: np.asarray(x)[lo_ch: lo_ch + per_ch], state)
    gains = (tc.second_order_gains(18.0), tc.second_order_gains(2.0))
    _, track_out = track_epochs_multihost(
        iq_scene, state_local, tables[lo_ch: lo_ch + per_ch],
        mesh=mesh_ch, fs=cfg.fs, pll_gains=gains[0], dll_gains=gains[1])

    np.savez(args.out, snr=snr, lo_shift=lo_shift, ca_shift=ca_shift,
             wall=np.float64(wall if wall is not None else np.nan),
             n_devices=np.int64(n_total),
             track_ip=np.asarray(track_out.ip),
             track_code_dev=np.asarray(track_out.code_dev))
    print(f"[p{args.process_id}] wrote {args.out} "
          f"snr_shape={snr.shape} devices={n_total}", flush=True)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(_worker())
