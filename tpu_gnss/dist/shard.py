"""Multi-device sharded acquisition.

The reference's only inter-processor transport is a 16-opcode SPI
command/response link between the Pi and the FPGA (reference: c/spi.cpp,
c/spi.h); its acquisition grid is a serial double loop on one core.  Here
the (PRN x Doppler x block) grid is sharded over a `jax.sharding.Mesh` and
the peak search is combined with XLA collectives:

* **Doppler sharding** (latency): each device searches a contiguous slice
  of the Doppler grid for all SVs; per-device bests are all-gathered and
  reduced in device order so tie-breaking matches the serial scan.
* **Block sharding** (throughput): different capture blocks to different
  devices — embarrassingly parallel, used for long captures.

Both compose: mesh ('blk', 'dop').
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..acquire.search import AcqResult, acquire_from_fft, mix_baseband


def make_mesh(n_devices: Optional[int] = None,
              axes: Sequence[str] = ("dop",),
              shape: Optional[Sequence[int]] = None) -> Mesh:
    """Build a mesh over the first ``n_devices`` devices."""
    devs = jax.devices()[: n_devices or len(jax.devices())]
    if shape is None:
        shape = (len(devs),) if len(axes) == 1 else None
    assert shape is not None and int(np.prod(shape)) == len(devs)
    return Mesh(np.asarray(devs).reshape(shape), axes)


def pad_dops(dops: np.ndarray, n_shards: int, dop_chunk: int) -> np.ndarray:
    """Pad the Doppler grid so each shard gets equal whole chunks.

    Padding replays the final bin; duplicates can never win the
    first-max-wins reduction over an ascending grid, so results are
    unchanged.
    """
    per = -(-len(dops) // (n_shards * dop_chunk)) * dop_chunk
    pad = per * n_shards - len(dops)
    return np.concatenate([dops, np.full(pad, dops[-1], dops.dtype)])


@functools.partial(jax.jit, static_argnames=("mesh", "lags", "dop_chunk"))
def acquire_from_fft_sharded(data_fft: jnp.ndarray, code_ffts: jnp.ndarray,
                             dops: jnp.ndarray, *, mesh: Mesh, lags: int,
                             dop_chunk: int = 16) -> AcqResult:
    """Doppler-sharded grid search for one block.

    ``dops`` length must divide evenly by mesh['dop'] (use :func:`pad_dops`).
    data/code spectra are replicated (they are small: ~10 MB for 32 SVs);
    only the Doppler axis is split.  The cross-device reduction all-gathers
    the tiny per-device best triples and reduces them in device order, the
    collective analog of the solver's snapshot assembly over SPI
    (reference: c/solve.cpp:62-85).
    """
    ndop_axis = mesh.shape["dop"]
    assert dops.shape[0] % ndop_axis == 0

    def body(data_fft, code_ffts, dops_local):
        res = acquire_from_fft(data_fft, code_ffts, dops_local,
                               lags=lags, dop_chunk=dop_chunk)
        snr_g = jax.lax.all_gather(res.snr, "dop")       # [ndev, n_sv]
        dop_g = jax.lax.all_gather(res.lo_shift, "dop")
        lag_g = jax.lax.all_gather(res.ca_shift, "dop")
        # first-max-wins across devices == serial ascending-Doppler scan
        idx = jnp.argmax(snr_g, axis=0)
        take = lambda a: jnp.take_along_axis(a, idx[None, :], 0)[0]
        return AcqResult(take(snr_g), take(dop_g), take(lag_g))

    spec_rep = P()
    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=(spec_rep, spec_rep, P("dop")),
        out_specs=AcqResult(spec_rep, spec_rep, spec_rep),
        check_vma=False)
    return fn(data_fft, code_ffts, dops)


@functools.partial(jax.jit,
                   static_argnames=("mesh", "fs", "lo_rate", "n_coherent",
                                    "dop_chunk", "period", "from_bits"))
def acquire_folded_sharded(blocks: jnp.ndarray, code_ffts_p: jnp.ndarray,
                           dops_hz: jnp.ndarray, *,
                           mesh: Mesh, fs: float, lo_rate: float,
                           n_coherent: int, dop_chunk: int = 16,
                           period: int = 0, from_bits: bool = True):
    """Block+Doppler sharded folded acquisition.

    The single-device batched engine
    (:func:`tpu_gnss.acquire.folded.acquire_folded_batch`) is also the
    scale-out engine: each (blk, dop) device wipes/folds/correlates its
    capture blocks over its contiguous Doppler slice, then per-device
    bests are all-gathered and reduced in device order (ascending
    Doppler, so tie-breaks match the serial scan).  ``dops_hz`` must
    divide by mesh['dop'] (:func:`pad_dops`), ``blocks`` by mesh['blk'].
    """
    from ..acquire.folded import FoldedResult, acquire_folded_batch
    assert blocks.shape[0] % mesh.shape["blk"] == 0
    assert dops_hz.shape[0] % mesh.shape["dop"] == 0

    def body(blocks_local, code_ffts_p, dops_local):
        res = acquire_folded_batch(
            blocks_local, code_ffts_p, dops_local, fs=fs, lo_rate=lo_rate,
            n_coherent=n_coherent, dop_chunk=dop_chunk,
            from_bits=from_bits, period=period)
        snr_g = jax.lax.all_gather(res.snr, "dop")    # [ndev, blk, n_sv]
        dop_g = jax.lax.all_gather(res.doppler_hz, "dop")
        lag_g = jax.lax.all_gather(res.ca_shift, "dop")
        idx = jnp.argmax(snr_g, axis=0)
        take = lambda a: jnp.take_along_axis(a, idx[None], 0)[0]
        return FoldedResult(take(snr_g), take(dop_g), take(lag_g))

    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P("blk"), P(), P("dop")),
        out_specs=FoldedResult(P("blk"), P("blk"), P("blk")),
        check_vma=False)
    return fn(blocks, code_ffts_p, dops_hz)


def make_tracker_sharded(*, mesh: Mesh, axis: str = "blk", fs: float,
                         pll_gains, dll_gains, epochs_per_step: int = 1,
                         have_code_ffts: bool = False,
                         agc_thresholds=None):
    """Build a reusable channel-sharded tracking step.

    Returns ``fn(samples, state, code_tables, code_ffts_or_None,
    aid_offset_hz) -> (state, EpochOut)``.  Building once and calling
    per chunk keeps the shard_map trace cached — constructing a fresh
    closure per chunk would re-trace the whole scan every time (the
    streaming receiver calls this at the chunk rate).

    ``aid_offset_hz`` is a traced operand (replicated scalar) so the
    replay oscillator-offset estimate can change without retracing.
    """
    from ..track.channel import track_epochs

    def body(samples, state, tables, *rest):
        if have_code_ffts:
            code_ffts_l, aid = rest
        else:
            (aid,) = rest
            code_ffts_l = None
        return track_epochs(samples, state, tables, fs=fs,
                            pll_gains=pll_gains, dll_gains=dll_gains,
                            epochs_per_step=epochs_per_step,
                            code_ffts=code_ffts_l,
                            agc_thresholds=agc_thresholds,
                            aid_offset_hz=aid)

    fn_cache: dict = {}

    def run(samples, state, code_tables, code_ffts=None,
            aid_offset_hz=0.0):
        n_dev = mesh.shape[axis]
        n_chan = code_tables.shape[0]
        assert n_chan % n_dev == 0, (n_chan, n_dev)
        aid = jnp.float32(aid_offset_hz)
        extra = ((code_ffts, aid) if have_code_ffts else (aid,))
        key = samples.shape
        fn = fn_cache.get(key)
        if fn is None:
            state_spec = jax.tree.map(lambda _: P(axis), state)
            out_spec = jax.tree.map(
                lambda _: P(None, axis),
                jax.eval_shape(body, samples, state, code_tables,
                               *extra)[1])
            extra_specs = ((P(axis), P()) if have_code_ffts else (P(),))
            fn = jax.jit(jax.shard_map(
                body, mesh=mesh,
                in_specs=(P(), state_spec, P(axis)) + extra_specs,
                out_specs=(state_spec, out_spec),
                check_vma=False))
            fn_cache[key] = fn
        return fn(samples, state, code_tables, *extra)

    return run


def track_epochs_sharded(samples: jnp.ndarray, state, code_tables, *,
                         mesh: Mesh, axis: str = "blk", fs: float,
                         pll_gains, dll_gains):
    """Channel-sharded tracking: the channel bank split across devices.

    Channels are independent given the shared sample stream (replicated —
    it is small: 1 ms epochs), so the bank shards cleanly over one mesh
    axis: each device scans its slice of the ChannelState pytree.  The
    analog of model parallelism for the reference's 12 FPGA channel
    slices (reference: c/gps.h:17; fabric utilization
    "Homemade GPS Receiver.html":57).

    n_chan must divide by mesh.shape[axis].  One-shot wrapper around
    :func:`make_tracker_sharded` (streaming callers build the tracker
    once instead).
    """
    run = make_tracker_sharded(mesh=mesh, axis=axis, fs=fs,
                               pll_gains=pll_gains, dll_gains=dll_gains)
    return run(samples, state, code_tables)


@functools.partial(jax.jit,
                   static_argnames=("mesh", "fs", "lo_rate", "n_coherent",
                                    "n_noncoherent", "dop_chunk", "period",
                                    "from_bits"))
def acquire_refined_sharded(samples: jnp.ndarray, code_ffts_p: jnp.ndarray,
                            dops_pad: jnp.ndarray, *, mesh: Mesh, fs: float,
                            lo_rate: float, n_coherent: int,
                            n_noncoherent: int = 1, dop_chunk: int = 64,
                            period: int = 0,
                            from_bits: bool = True) -> jnp.ndarray:
    """Doppler-sharded one-round-trip cold search: grid reduce + refine.

    The mesh version of :func:`tpu_gnss.acquire.folded.acquire_refined`
    — each device reduces its contiguous Doppler slice to per-bin
    bests, the per-bin SNR rows are all-gathered (ascending-Doppler
    order, so the argmax tie-break matches the single-device scan), and
    the ±2-bin window refinement (`_refine_from_centers`, the SAME
    arithmetic as single-device) runs replicated.  Returns the stacked
    ``[3, n_sv]`` (snr, doppler_hz, ca_shift) — one host fetch.

    ``dops_pad`` must divide by mesh['dop'] in whole ``dop_chunk`` units
    (use :func:`pad_dops`); padding replays the last bin and cannot win
    the first-max argmax.
    """
    from ..acquire.folded import _corr_reduce_grid, _refine_from_centers
    ndev = mesh.shape["dop"]
    assert dops_pad.shape[0] % (ndev * dop_chunk) == 0

    def body(samples, code_ffts_p, dops_local, dops_full):
        iq = (mix_baseband(samples, lo_rate) if from_bits
              else samples.astype(jnp.complex64))
        block = n_coherent * period
        blocks = iq[: n_noncoherent * block].reshape(n_noncoherent, block)
        pk, _, tt = _corr_reduce_grid(
            blocks, code_ffts_p, dops_local, fs=fs, n_coherent=n_coherent,
            dop_chunk=dop_chunk, period=period, accumulate=True)
        nd_local = dops_local.shape[0]
        snr_local = (pk / (tt / period))[0, :, :nd_local]  # [sv, nd_local]
        snr_g = jax.lax.all_gather(snr_local, "dop", axis=1, tiled=True)
        centers = dops_full[jnp.argmax(snr_g, axis=-1)]
        return _refine_from_centers(blocks, code_ffts_p, centers,
                                    dops_full, fs=fs,
                                    n_coherent=n_coherent, period=period)

    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), P("dop"), P()),
        out_specs=P(),
        check_vma=False)
    return fn(samples, code_ffts_p, dops_pad, dops_pad)


@functools.partial(jax.jit,
                   static_argnames=("mesh", "lo_rate", "lags", "dop_chunk",
                                    "variant"))
def acquire_blocks_sharded(bits_blocks: jnp.ndarray, code_ffts: jnp.ndarray,
                           dops: jnp.ndarray, *, mesh: Mesh, lo_rate: float,
                           lags: int, dop_chunk: int = 16,
                           variant: str = "offline") -> AcqResult:
    """Block+Doppler sharded full front end for a batch of 1-bit blocks.

    ``bits_blocks``: ``[n_blk, fft_len]`` with n_blk divisible by
    mesh['blk'].  Each (blk, dop) device mixes and FFTs its blocks locally
    and searches its Doppler slice; results are ``[n_blk]`` AcqResults
    (per-block, per-SV bests).
    """
    n_blk = bits_blocks.shape[0]
    assert n_blk % mesh.shape["blk"] == 0
    assert dops.shape[0] % mesh.shape["dop"] == 0

    def body(bits_local, code_ffts, dops_local):
        iq = mix_baseband(bits_local, lo_rate, variant)
        data_ffts = jnp.fft.fft(iq, axis=-1)
        res = jax.vmap(
            lambda df: acquire_from_fft(df, code_ffts, dops_local,
                                        lags=lags, dop_chunk=dop_chunk)
        )(data_ffts)
        snr_g = jax.lax.all_gather(res.snr, "dop")       # [ndev, blk, n_sv]
        dop_g = jax.lax.all_gather(res.lo_shift, "dop")
        lag_g = jax.lax.all_gather(res.ca_shift, "dop")
        idx = jnp.argmax(snr_g, axis=0)
        take = lambda a: jnp.take_along_axis(a, idx[None], 0)[0]
        return AcqResult(take(snr_g), take(dop_g), take(lag_g))

    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P("blk"), P(), P("dop")),
        out_specs=AcqResult(P("blk"), P("blk"), P("blk")),
        check_vma=False)
    return fn(bits_blocks, code_ffts, dops)
