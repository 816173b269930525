"""Full offline receiver pipeline: capture in, position fixes out.

The runtime layer replacing the reference's cooperative-coroutine
scheduler + task zoo (reference: c/coroutines.cpp, c/main.cpp:66-68 — one
search task, 12 channel tasks, one solve task round-robining on a Pi).
Here the "tasks" are pipeline stages over arrays:

  acquisition (device, batched)  ->  channel allocation (host)
  tracking scan (device, chunked) -> NAV bit/frame decode (host)
  ephemeris ingest               ->  PVT solve every 4 s (host)

One streaming loop serves every input kind (host arrays wrap into an
:class:`tpu_gnss.io.stream.ArraySource`).  The loop is pipelined the way
the reference pipelines its SPI link (request N+1 issued before response
N is read, c/spi.cpp:34-53): chunk k's tracking scan is dispatched to the
device BEFORE chunk k-1's correlator outputs are fetched, so the host's
decode/bookkeeping overlaps device compute.  Host<->device traffic per
chunk is one quantized int8 upload (or 1-bit samples for packed captures)
and one [5, epochs, chan] float32 download — the analog of the
reference FPGA's integrate-and-dump decimation that hands the Pi 50 bps
instead of 10 Msps ("Homemade GPS Receiver.html":306).

Channel-management semantics follow the reference: strongest detections
fill the channel bank, a power watchdog frees dead channels and re-queues
their PRN for search (reference: c/channel.cpp:211-254 SignalLost), and
probation — a channel must decode parity-clean subframes before the
solver trusts it (reference: c/channel.cpp:39,343,363) — maps to
requiring a validated subframe + valid ephemeris per channel.  Weak-signal
cold starts escalate to non-coherent accumulation over multiple coherent
blocks (SURVEY §5's sensitivity mechanism; the reference never had it).

Transmit-time reconstruction is code-locked: an unwrapped chip counter
per channel (integrated from the tracked code rate) counts transmit time
from the last decoded subframe boundary, the software analog of the
reference's ms/bit counters + G1 snapshot arithmetic
(reference: c/solve.cpp:118-133).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from .constants import CHIP_RATE_HZ, CODES_PER_BIT, CODE_LEN_CHIPS
from .config import ReceiverConfig
from .acquire.folded import FoldedSearcher
from .nav import almanac as nav_almanac
from .nav import bits as nav_bits
from .nav.ephemeris import Ephemeris
from .pvt import solve as pvt
from .track import channel as tc

_HIST_KEYS = ("ip", "qp", "cf", "caf", "chips")


@dataclasses.dataclass
class ChannelRecord:
    """Host-side per-channel bookkeeping (the CHANNEL struct analog).

    Histories are stored as per-chunk numpy arrays and concatenated
    lazily — O(total) work, no per-epoch python objects.  The unwrapped
    chip counter is integrated incrementally at append time (the fix for
    the old full-history cumsum per solve snapshot).
    """
    ch: int
    prn: int
    start_epoch: int
    code_phase0: float = 0.0      # chips at start_epoch
    bit_offset: Optional[int] = None
    bits: Optional[np.ndarray] = None
    eph: Ephemeris = dataclasses.field(default_factory=Ephemeris)
    subframes: list = dataclasses.field(default_factory=list)
    last_subframe_bit: Optional[int] = None   # bit index of last subframe
    last_tow: Optional[int] = None
    cn0_dbhz: Optional[float] = None
    code_lock: Optional[float] = None   # prompt/sides ratio, last chunk
    # (end_epoch, ratio) per drained chunk: the solver samples the
    # ratio at its snapshot epoch instead of gating an old snapshot on
    # the FINAL chunk's lock state (a channel that degraded late must
    # not retroactively veto earlier, healthy snapshots)
    code_lock_hist: list = dataclasses.field(default_factory=list)
    # hot-start TOW anchors from preamble+HOW pairs at the undecoded
    # stream tail (nav/bits.partial_anchors); rebuilt per decode pass
    partial_anchors: list = dataclasses.field(default_factory=list)
    lost: bool = False
    n_epochs: int = 0
    trim_epochs: int = 0          # epochs dropped from the history front
    _decoded_upto: int = 0        # absolute epoch the last NAV pass covered
    archived_subframes: list = dataclasses.field(default_factory=list)
    _chunks: dict = dataclasses.field(
        default_factory=lambda: {k: [] for k in _HIST_KEYS})
    _cat: dict = dataclasses.field(default_factory=dict)
    _chip_base: float = 0.0       # integrated chips before current chunk
    _cp_last: Optional[float] = None   # device code phase at last epoch
    _ref_pwr: Optional[float] = None   # watchdog reference power

    # ------------------------------------------------------------------
    def append_hist(self, ip: np.ndarray, qp: np.ndarray, cf: np.ndarray,
                    caf: np.ndarray, t_epoch: float,
                    cp: Optional[np.ndarray] = None) -> None:
        """Append one chunk of per-epoch correlator outputs.

        ``cf`` is the tracker's code-rate DEVIATION history (chips/s
        relative to CHIP_RATE_HZ, tpu_gnss.track.channel.EpochOut).

        ``cp`` is the tracker's own per-epoch code PHASE (chips mod
        1023, EpochOut.code_phase).  When given, the transmit-time chip
        integral is anchored to it: every 1 ms epoch advances exactly
        one code period plus the wrapped phase difference, so the count
        inherits the DLL's lock to the signal and per-epoch errors stay
        bounded at the float32 phase quantization (~6e-5 chips ≈ 2 cm)
        WITHOUT accumulating.  Integrating the commanded rates instead
        (the ``cp=None`` fallback) drifts: the device advances its
        float32 phase with rounding that the DLL absorbs by adjusting
        later commands, so a float64 integral of those commands walks
        away from the device's truth-locked phase by the accumulated
        rounding bias — the ~1.9 m -> 8 m fix-error growth observed
        between 60 s and 300 s soaks.
        """
        self._chunks["ip"].append(ip)
        self._chunks["qp"].append(qp)
        self._chunks["cf"].append(cf)
        self._chunks["caf"].append(caf)
        # the two integral conventions must never mix on one record:
        # the cp branch carries code_phase0 inside _chip_base, the cf
        # fallback adds it separately — switching mid-record would
        # double-count up to one code period (~300 km of pseudorange)
        if cp is not None:
            assert self._chip_base == 0.0 or self._cp_last is not None, \
                "record already uses the command-integral fallback"
            cp64 = np.asarray(cp, np.float64)
            wrap = lambda x: (x + 511.5) % CODE_LEN_CHIPS - 511.5
            if self._cp_last is None:
                # A[0] defined == code_phase0 (cp[0] is its mod-1023
                # image); later epochs chain off the device phase
                d = wrap(np.diff(cp64))
                steps = np.concatenate([[0.0], CODE_LEN_CHIPS + d])
                chips = self.code_phase0 + np.cumsum(steps)
            else:
                d = wrap(np.diff(cp64, prepend=self._cp_last))
                chips = self._chip_base + np.cumsum(CODE_LEN_CHIPS + d)
            self._chip_base = float(chips[-1])
            self._cp_last = float(cp64[-1])
        else:
            assert self._cp_last is None, \
                "record already uses the device-phase integral"
            cf64 = np.asarray(cf, np.float64) + CHIP_RATE_HZ
            chips = (self.code_phase0 + self._chip_base
                     + np.concatenate([[0.0],
                                       np.cumsum(cf64[:-1])]) * t_epoch)
            self._chip_base += float(cf64.sum()) * t_epoch
        self._chunks["chips"].append(chips)
        self.n_epochs += len(ip)
        self._cat.clear()

    def hist(self, key: str) -> np.ndarray:
        """Retained history (cached until the next append/trim).

        Index i holds epoch ``trim_epochs + i`` (channel-relative);
        use :meth:`abs_slice` for absolute-epoch windows.
        """
        got = self._cat.get(key)
        if got is None:
            parts = self._chunks[key]
            got = (np.concatenate(parts) if parts
                   else np.empty(0, np.float32))
            self._cat[key] = got
        return got

    def abs_slice(self, key: str, lo: int, hi: int) -> np.ndarray:
        """History window by ABSOLUTE channel epochs [lo, hi)."""
        t = self.trim_epochs
        return self.hist(key)[max(lo - t, 0): max(hi - t, 0)]

    def abs_at(self, key: str, e: int):
        """History value at absolute channel epoch ``e``."""
        return self.hist(key)[e - self.trim_epochs]

    def trim_to(self, keep_epochs: int) -> None:
        """Bound retained history to ~the last ``keep_epochs`` epochs.

        Whole leading chunks are dropped (no copies); the absolute
        epoch <-> array index mapping shifts by ``trim_epochs``.
        Transmit-time anchors survive trimming because a_edge is an
        ABSOLUTE chip count (period-grid bit sync) — anchors decoded
        from since-trimmed history are moved to ``archived_subframes``
        by the next NAV decode pass.
        """
        while self._chunks["ip"]:
            head = len(self._chunks["ip"][0])
            if self.n_epochs - (self.trim_epochs + head) < keep_epochs:
                break
            for k in _HIST_KEYS:
                self._chunks[k].pop(0)
            self.trim_epochs += head
            self._cat.clear()

    def tail(self, key: str, n: int) -> np.ndarray:
        """Last ``n`` epochs of one history without a full concat."""
        parts, have = [], 0
        for arr in reversed(self._chunks[key]):
            parts.append(arr)
            have += len(arr)
            if have >= n:
                break
        if not parts:
            return np.empty(0, np.float32)
        return np.concatenate(parts[::-1])[-n:]

    def code_lock_at(self, e_local: int) -> Optional[float]:
        """Code-lock ratio of the chunk containing channel epoch e_local.

        Returns None when no contemporaneous measurement exists (the
        snapshot predates the history or trails the last drained chunk
        by more than one chunk) — callers skip the gate then.
        """
        import bisect
        h = self.code_lock_hist
        if not h:
            return self.code_lock
        i = bisect.bisect_left(h, e_local, key=lambda t: t[0])
        if i < len(h):
            if i == 0 and len(h) > 1:
                # history head may have been trimmed: only trust the
                # first entry for epochs inside its own chunk
                span0 = h[1][0] - h[0][0]
                if e_local <= h[0][0] - span0:
                    return None
            return h[i][1]
        span = h[-1][0] - (h[-2][0] if len(h) > 1 else 0)
        return h[-1][1] if e_local - h[-1][0] <= max(span, 1) else None

    @property
    def ip_hist(self) -> np.ndarray:
        return self.hist("ip")

    @property
    def qp_hist(self) -> np.ndarray:
        return self.hist("qp")

    @property
    def code_freq_hist(self) -> np.ndarray:
        """Absolute code rate (chips/s); stored history is the deviation."""
        return self.hist("cf").astype(np.float64) + CHIP_RATE_HZ

    @property
    def carrier_freq_hist(self) -> np.ndarray:
        return self.hist("caf")


@dataclasses.dataclass
class ReceiverResult:
    detections: list
    channels: List[ChannelRecord]
    solutions: List[pvt.Solution]


class Receiver:
    """Offline full-chain receiver for complex-baseband or 1-bit captures."""

    def __init__(self, cfg: ReceiverConfig, pll_bn_hz: float = 18.0,
                 dll_bn_hz: float = 2.0, n_coherent: int = 4,
                 solve_interval_s: float = 4.0,
                 los_power_ratio: float = 0.05,
                 los_timeout_s: float = 2.0,
                 epochs_per_step: int = 10,
                 reacq_interval_s: float = 5.0,
                 fft_correlator: bool = True,
                 agc_thresholds: Optional[tuple] = None,
                 weak_min_svs: int = 4,
                 weak_noncoherent: int = 8,
                 transfer_dtype: str = "int8",
                 quality_gate: bool = True,
                 cn0_gate_dbhz: float = 25.0,
                 lock_gate: float = 0.45,
                 raim_residual_m: float = 500.0,
                 max_history_s: Optional[float] = None,
                 probation_s: float = 30.0,
                 code_lock_gate: float = 1.3,
                 if_offset_hz="auto",
                 mesh=None):
        self.cfg = cfg
        self.searcher = FoldedSearcher(cfg, n_coherent=n_coherent)
        self._n_coherent = n_coherent
        # directed cold search (almanac warm start): a FoldedSearcher
        # over the predicted-visible PRN subset; falls back to the full
        # sweep when the directed set under-delivers (stale almanac)
        self._searcher_directed = None
        # almanac store: subframe 4/5 SV pages decoded from any channel,
        # plus reductions of every validated ephemeris (strictly better
        # data than the broadcast page).  Persisted via utils.checkpoint
        # and used by nav.almanac.visible_prns to direct the next
        # session's cold search.  The reference discards these pages
        # (c/ephemeris.cpp:183-207 dispatches only ids 1-3 + iono).
        self.almanac = {}
        t_s = epochs_per_step * 1e-3
        self.pll_gains = tc.second_order_gains(pll_bn_hz, t_s=t_s)
        self.dll_gains = tc.second_order_gains(dll_bn_hz, t_s=t_s)
        self.epochs_per_step = epochs_per_step
        self.solve_interval_s = solve_interval_s
        self.los_power_ratio = los_power_ratio
        self.los_timeout_s = los_timeout_s
        self.reacq_interval_s = reacq_interval_s
        self.fft_correlator = fft_correlator
        # strong-signal Costas gain reduction (reference:
        # c/channel.cpp:265-288); (lo, hi) on the running prompt power.
        # tuple() because it becomes a hashable jit-static argument.
        self.agc_thresholds = (tuple(agc_thresholds)
                               if agc_thresholds is not None else None)
        # weak-signal escalation: when a single-block cold search finds
        # fewer than ``weak_min_svs`` SVs, retry with ``weak_noncoherent``
        # blocks accumulated non-coherently (needs that much input).
        # The accumulated sweep thresholds at the false-alarm-equalized
        # level with the near-far cross-correlation guard
        # (acquire/folded.noncoherent_threshold), so deeper accumulation
        # buys real sensitivity; k=8 is ~32 ms of head, well inside the
        # smallest chunk, and only runs when the receiver is short of a
        # solvable constellation.  Sensitivity cap: the guard floor
        # scales with the sweep's strongest SNR, so in a strong-signal
        # scene the escalation cannot report genuine SVs >13 dB below
        # the strongest — they sit inside the C/A cross-correlation
        # ambiguity (acquire/folded.CROSS_GUARD discussion).
        self.weak_min_svs = weak_min_svs
        self.weak_noncoherent = weak_noncoherent
        # complex-capture uplink quantization: "int8" sends quantized
        # planes (4x less traffic than float32, dequantized on device),
        # "int4" sends packed nibbles (8x less; <0.1 dB SNR cost — for
        # bandwidth-bound links), "int2" sends sign/magnitude pairs
        # (16x less; ~0.55 dB — the classic 2-bit GNSS ADC operating
        # point), "float32" sends exact planes.  For 8-bit capture
        # FILES, "int8" means the file's own bytes cross the link
        # untouched; "int4"/"int2" requantize them 2x/4x smaller.
        self.transfer_dtype = transfer_dtype
        # solver inclusion gates + C/N0 weighting (probation analog,
        # reference: c/channel.cpp:39,343,363): a channel must be
        # Costas-locked and above the C/N0 floor before the solver
        # trusts it; trusted channels are weighted by linear C/N0
        self.quality_gate = quality_gate
        self.cn0_gate_dbhz = cn0_gate_dbhz
        self.lock_gate = lock_gate
        # fix integrity: weighted post-fit residual RMS gate + RAIM
        # fault exclusion (pvt.solve_position_raim)
        self.raim_residual_m = raim_residual_m
        # adaptive fault exclusion: running residual baseline; a fix
        # whose residual jumps far above the receiver's OWN noise level
        # triggers exclusion even though it is far below the gross gate
        # (a single glitched pseudorange of ~10 m self-flags as a
        # 5-10x residual spike — BENCH_soak300 t=192 s)
        from collections import deque
        self._resid_hist = deque(maxlen=32)
        # live/unbounded streams: bound per-channel history to this many
        # seconds (transmit-time anchors survive trimming — a_edge is an
        # absolute chip count; decoded anchors are archived).  None =
        # keep everything (batch mode).
        self.max_history_s = max_history_s
        # probation: seconds of DECODED prompt stream with zero
        # parity-valid subframes before a channel is declared a false
        # acquisition and freed (only fires where NAV decode runs
        # in-stream; a batch run decodes once at the end)
        self.probation_s = probation_s
        # code-lock gate on the chunk-mean prompt/sides ratio (~2 when
        # centered on the peak, ~1 when the DLL slipped off)
        self.code_lock_gate = code_lock_gate
        # replay-capture oscillator offset (the reason the reference
        # searches replayed captures at max_fo=100000, README.md §2.1e):
        # a common carrier offset that does NOT scale the code rate.
        # "auto" estimates it from the median cold-start Doppler when
        # that median is implausibly large for sky motion (>10 kHz);
        # a float pins it; 0.0 disables.  It feeds (a) the code-rate
        # seed/aiding split and (b) the velocity solve's Doppler input.
        self.if_offset_hz = if_offset_hz
        self._if_offset = (0.0 if if_offset_hz == "auto"
                           else float(if_offset_hz))
        self._if_offset_locked = if_offset_hz != "auto"
        # distributed mode: a jax.sharding.Mesh with a "dop" axis.  The
        # SAME streaming receiver then runs its heavy stages on the mesh
        # — cold/re-acquisition Doppler-sharded and the tracking bank
        # channel-sharded — with NAV+PVT on host,
        # the whole-system integration the reference runs across its
        # two processors (c/main.cpp:66-68 task zoo over the SPI link).
        # n_channels must divide the mesh device count.
        self.mesh = mesh
        self._tracker_sharded = None
        if mesh is not None:
            assert "dop" in mesh.axis_names, \
                "receiver mesh needs a 'dop' axis (used for both the " \
                "Doppler grid and the channel bank)"
            from .dist import shard as dshard
            self._tracker_sharded = dshard.make_tracker_sharded(
                mesh=mesh, axis="dop", fs=cfg.fs,
                pll_gains=self.pll_gains, dll_gains=self.dll_gains,
                epochs_per_step=epochs_per_step,
                have_code_ffts=fft_correlator,
                agc_thresholds=self.agc_thresholds)

    # ------------------------------------------------------------------
    def _resolve_engine(self) -> str:
        """Cold-search engine: the refined one-program search (chunked
        grid reduce + on-device ±2-bin refinement, one ``[3, n_sv]``
        fetch), Doppler-sharded on a mesh.  The same on every platform.
        """
        return "refined" if self.mesh is None else "refined_sharded"

    def _prewarm_acq(self, head_len: int, bits: bool) -> None:
        """Compile + cache the cold-search k=1 program on dummy input.

        Runs in a background thread during first-chunk I/O so the real
        cold search finds the program compiled (in-process jit cache)
        or at worst persisted (disk cache) — it was 5.7 s of the 9 s
        cold time-to-first-fix, serialized behind the first read.  Only
        the k=1 program is warmed: it alone gates cold TTFF (the weak-
        signal escalation runs only when the sky comes up short, and
        the background re-acq thread absorbs its compile).  All-zero
        dummy input yields NaN SNRs -> zero detections by the NaN-safe
        threshold, so the warmup has no side effects.
        """
        import os as _os
        import time as _t
        trace_cold = bool(_os.environ.get("TPU_GNSS_TRACE_COLD"))
        _t0 = _t.perf_counter()
        try:
            searcher = self._searcher_directed or self.searcher
            engine = self._resolve_engine()
            head = np.zeros(head_len,
                            np.uint8 if bits else np.complex64)
            kw = dict(bits=head) if bits else dict(iq=head)
            if engine == "refined_sharded":
                searcher.detections_refined_sharded(**kw, mesh=self.mesh)
            else:
                searcher.detections_refined_fast(**kw)
            if trace_cold:
                print(f"[cold] acq prewarm body "
                      f"{_t.perf_counter()-_t0:.2f}s", flush=True)
        except Exception as e:
            if trace_cold:
                print(f"[cold] acq prewarm FAILED {e!r}", flush=True)
            # prewarm is best-effort; the real call compiles

    def _cold_detections(self, head, bits: bool = False,
                         skip_prns=frozenset()) -> list:
        """Refined detections for channel seeding, engine-dispatched.

        ``head`` is a complex-baseband segment, or raw {0,1} samples when
        ``bits`` (mixed on device).  When the single-block search comes
        up short and ``head`` spans several coherent blocks, the search
        escalates to non-coherent accumulation (weak-signal mode).

        ``skip_prns``: PRNs already tracked — dropped before refinement
        (cheap fruitless re-probes) and counted as found by the
        weak-signal escalation check.

        A directed searcher (almanac warm start, ``search_prns``) sweeps
        only the predicted-visible subset; when even the weak-signal
        escalation leaves it short of ``weak_min_svs``, the full 32-PRN
        sweep runs once as a fallback and the directed searcher is
        dropped for the rest of the run (stale almanac).  A SUCCESSFUL
        directed sweep also retires it: its job is the cold start, and
        later background re-acquisition must keep SVs reachable that
        rise beyond the almanac prediction's time margin.
        """
        import os as _os
        import time as _t
        trace_cold = bool(_os.environ.get("TPU_GNSS_TRACE_COLD"))
        searcher = self._searcher_directed or self.searcher
        # a cold-search prewarm in flight compiles the SAME k=1 program
        # this call needs: wait for it instead of compiling twice
        t = getattr(self, "_acq_prewarm_done", None)
        if t is not None:
            _t0 = _t.perf_counter()
            t.wait()
            self._acq_prewarm_done = None
            if trace_cold:
                print(f"[cold] prewarm wait {_t.perf_counter()-_t0:.2f}s",
                      flush=True)
        engine = self._resolve_engine()
        kw = dict(bits=head) if bits else dict(iq=head)

        def run(n_nc, searcher):
            if engine == "refined_sharded":
                return searcher.detections_refined_sharded(
                    **kw, n_noncoherent=n_nc, skip_prns=skip_prns,
                    mesh=self.mesh)
            return searcher.detections_refined_fast(
                **kw, n_noncoherent=n_nc, skip_prns=skip_prns)

        def sweep(searcher):
            dets = run(1, searcher)
            k = min(self.weak_noncoherent,
                    len(head) // searcher.block_len)
            if len(dets) + len(skip_prns) < self.weak_min_svs and k > 1:
                weak = run(k, searcher)
                if len(weak) > len(dets):
                    dets = weak
            return dets

        dets = sweep(searcher)
        if searcher is not self.searcher:
            if len(dets) + len(skip_prns) < self.weak_min_svs:
                self._searcher_directed = None
                full = sweep(self.searcher)
                if len(full) > len(dets):
                    dets = full
            elif dets:
                # the directed grid's job is the COLD start; once it has
                # seeded channels, background re-acquisition reverts to
                # the full constellation — SVs rising beyond the almanac
                # prediction's margin must stay reachable on a long run
                self._searcher_directed = None
        return dets

    # ------------------------------------------------------------------
    def process_iq(self, iq: np.ndarray, max_channels: Optional[int] = None,
                   chunk_s: float = 2.0) -> ReceiverResult:
        """Run the full chain over a host complex-baseband capture."""
        from .io.stream import ArraySource
        return self.process_source(ArraySource(iq, self.cfg.fs),
                                   max_channels=max_channels,
                                   chunk_s=chunk_s)

    # ------------------------------------------------------------------
    def process_source(self, source, max_duration_s: Optional[float] = None,
                       max_channels: Optional[int] = None,
                       chunk_s: float = 1.0,
                       warm_ephemerides: Optional[dict] = None,
                       search_prns=None,
                       on_solution=None) -> ReceiverResult:
        """Streaming full chain over a :class:`tpu_gnss.io.stream` source.

        Bounded memory: raw samples are consumed chunk-by-chunk; only the
        per-epoch correlator outputs are retained (kB/s/channel scale —
        the same reduction the reference's FPGA integrate-and-dump
        achieves before the Pi ever sees data).

        ``warm_ephemerides``: {prn: Ephemeris} from a previous run's
        checkpoint.  A warm channel only needs ONE subframe (any id) for
        its TOW anchor instead of decoding all of 1-3 — first fix in ~7 s
        of capture instead of ~20 s.

        ``on_solution``: live-mode fix sink.  When given, NAV decode +
        PVT run IN-STREAM at the solve cadence (the reference's 4 s
        SolveTask loop, c/solve.cpp:297-317) and each fix is delivered
        as it is computed — required for unbounded/following sources
        where "at the end" never comes.

        ``search_prns``: restrict the cold/re-acquisition sweep to this
        PRN subset (typically ``nav.almanac.visible_prns`` from a
        checkpoint's almanac + last fix).  A proper subset cuts the
        cold-search grid proportionally; the receiver falls back to the
        full sweep if the directed set under-delivers.
        """
        import jax.numpy as jnp
        from .io.stream import Prefetcher
        from .utils.metrics import METRICS

        cfg = self.cfg
        self._searcher_directed = None
        if search_prns is not None:
            subset = tuple(sorted(set(int(x) for x in search_prns)
                                  & set(cfg.prns)))
            if subset and subset != tuple(cfg.prns):
                self._searcher_directed = FoldedSearcher(
                    dataclasses.replace(cfg, prns=subset),
                    n_coherent=self._n_coherent)
        p = round(cfg.fs * 1e-3)
        eps = self.epochs_per_step
        assert round(chunk_s * 1000) % eps == 0, \
            "chunk_s must cover whole tracking steps"
        chunk_len = max(1, round(chunk_s * 1000)) * p
        # fast path for 1-bit sources: transfer the capture's own packed
        # words (1 bit/sample — 8x less than unpacked bytes, 64x less
        # than int8 planes) and run unpack + quadrature mix on device
        # with a running sample offset — host stays at file-I/O speed.
        # Sources configured for the reference's per-block LO phase
        # restart must keep their own (host) mixing.
        onebit_src = not getattr(source, "per_block_phase", False)
        use_packed = (onebit_src and hasattr(source, "packed_blocks")
                      and chunk_len % 32 == 0)
        use_bits = (onebit_src and hasattr(source, "bit_blocks")
                    and not use_packed)
        # 8-bit capture fast path: the file's own interleaved bytes cross
        # the link (no host quantize/deinterleave pass); conversion runs
        # on device (utils.xfer.to_device_iq8)
        use_rawiq = (not use_packed and not use_bits
                     and hasattr(source, "raw_blocks")
                     and getattr(source, "dtype", None) in ("int8",
                                                            "uint8"))
        mode = ("packed" if use_packed else "bits" if use_bits
                else "rawiq" if use_rawiq else "iq")
        n_samples = ((lambda b: 32 * len(b)) if use_packed
                     else (lambda b: len(b) // 2) if use_rawiq else len)

        # Host->device uploads run IN the prefetch thread (JAX dispatch
        # is thread-safe), so the link transfer of chunk k+1 overlaps
        # chunk k's device compute and output fetch instead of
        # serializing with them — the deepest version of the reference's
        # SPI request/response pipelining (c/spi.cpp:34-53).  Items on
        # the queue are (host_blk, device_seg, n_ep, n_samp).
        xfer_state = {"sample0": 0, "skipped_bytes": 0}
        # --max-lag skip-ahead keeps the LO mix phase aligned with the
        # TRUE file sample index: the follow reader reports skipped
        # bytes, and the upload counter advances by the elided samples
        # (8 samples/byte on the 1-bit paths, where sample0 drives the
        # mix phase).  Without this, every skip permanently offsets the
        # device LO phase from the capture's.
        skip_reader = (getattr(source, "reader", None)
                       if (use_packed or use_bits) else None)

        def upload(blk):
            n_samp = n_samples(blk)
            n_ep = (n_samp // p // eps) * eps
            if n_ep == 0:
                return (blk, None, 0, n_samp)
            if skip_reader is not None:
                sk = skip_reader.skipped_bytes
                if sk > xfer_state["skipped_bytes"]:
                    xfer_state["sample0"] += \
                        8 * (sk - xfer_state["skipped_bytes"])
                    xfer_state["skipped_bytes"] = sk
            s0 = xfer_state["sample0"]
            xfer_state["sample0"] = s0 + n_ep * p
            with METRICS.stage("receiver.transfer"):
                if use_packed and n_ep * p == n_samp:
                    # full word-aligned chunks: device unpack+mix of
                    # the file's own packed words
                    seg = self._mix_chunk_packed(blk, s0)
                elif use_packed:
                    # final PARTIAL chunk (not whole epochs): unpack on
                    # host, trim to whole epochs, ship as bits — a
                    # one-off at stream end, not worth a kernel shape
                    from .io import loaders as _ld
                    bits = _ld.unpack_1bit(blk.tobytes())[: n_ep * p]
                    seg = self._transfer(bits, True, s0)
                elif use_rawiq:
                    from .utils.xfer import (to_device_iq2, to_device_iq4,
                                             to_device_iq8)
                    fn = (to_device_iq2 if self.transfer_dtype == "int2"
                          else to_device_iq4
                          if self.transfer_dtype == "int4"
                          else to_device_iq8)
                    seg = fn(blk[: 2 * n_ep * p],
                             signed=source.dtype == "int8",
                             remove_dc=getattr(source, "remove_dc", True))
                else:
                    seg = self._transfer(blk[: n_ep * p], use_bits, s0)
            return (blk, seg, n_ep, n_samp)

        # Pre-build the COLD-SEARCH program while the first chunk is
        # read/uploaded: the k=1 refined-acquisition compile was 5.7 s
        # of the 9 s cold TTFF, fully serialized behind the first read.
        # The prewarm thread compiles it on dummy input (populating the
        # in-process jit cache); _cold_detections waits on the event
        # instead of racing a duplicate compile.
        import threading as _thr
        acq_head = min(self.weak_noncoherent * self.searcher.block_len,
                       chunk_len)
        acq_bits = use_packed or use_bits
        self._acq_prewarm_done = _ev = _thr.Event()

        # Two prewarm threads: the search-side chain (acquisition
        # program, then the channel-seeding program that follows it on
        # the cold path) and the tracker bring-up.  With the
        # exported-program cache hot these are mostly executable load,
        # so they overlap each other and the first-chunk read — the
        # tracker load (the longest pole) must start at t=0, not after
        # the search chain.
        def _warm_chain():
            try:
                self._prewarm_acq(acq_head, acq_bits)
            finally:
                _ev.set()

        def _warm_seeder():
            try:
                # the batched channel-seeding program sits between the
                # cold search and the first tracking chunk (~0.5 s
                # trace+compile) — warm it from t=0 so it is ready
                # before the real seeding at ~1.2 s
                n = max_channels or cfg.num_chans
                tc.start_channels(tc.init_state(n), [0], [0.0], [0.0],
                                  [0.0])
            except Exception:
                pass

        # The tracking prewarm (second link of the chain above): a dummy
        # CALL through the same wrapper as the real loop populates the
        # in-process jit cache AND the exported-program path (an AOT
        # lower+compile seeds only the disk compile cache — the real
        # call would still pay a full re-trace).
        def _track_prewarm(chunk_len=chunk_len, n=(max_channels
                                                   or cfg.num_chans)):
            try:
                import jax
                import jax.numpy as _jnp

                from .utils import progcache
                tables, code_ffts = self._tables_for((None,) * n, n)
                # the zero segment is BUILT on device inside jit: an
                # eager complex64 constant would cross the host->device
                # boundary, which this backend cannot transfer
                # (utils.xfer planes rule) — and a failed dispatch in
                # this thread wedges the whole client
                seg0 = jax.jit(
                    lambda n=chunk_len: jax.lax.complex(
                        _jnp.zeros(n, _jnp.float32),
                        _jnp.zeros(n, _jnp.float32)))()
                out = progcache.call(
                    "track_epochs", tc.track_epochs,
                    args=(seg0, tc.init_state(n), tables),
                    dyn_kwargs=dict(code_ffts=code_ffts,
                                    aid_offset_hz=0.0),
                    static_kwargs=dict(
                        fs=cfg.fs, pll_gains=self.pll_gains,
                        dll_gains=self.dll_gains,
                        epochs_per_step=eps,
                        agc_thresholds=self.agc_thresholds))
                jax.block_until_ready(out[0])
            except Exception:
                pass   # prewarm is best-effort; the real call compiles

        _thr.Thread(target=_warm_chain, daemon=True).start()
        _thr.Thread(target=_warm_seeder, daemon=True).start()
        if self.mesh is None:
            _thr.Thread(target=_track_prewarm, daemon=True).start()

        prefetcher = Prefetcher(source, chunk_len, mode=mode,
                                transform=upload)
        try:
            return self._stream_loop(
                iter(prefetcher), source, n_samples, p, eps,
                chunk_len=chunk_len,
                use_packed=use_packed, use_bits=use_bits,
                use_rawiq=use_rawiq, max_duration_s=max_duration_s,
                max_channels=max_channels,
                warm_ephemerides=warm_ephemerides,
                on_solution=on_solution)
        finally:
            # release the pump thread + its queued device buffers + the
            # open capture on EVERY exit path (early max_duration_s
            # break, exceptions, clean EOF)
            prefetcher.stop()

    def _stream_loop(self, blocks, source, n_samples, p, eps, *,
                     chunk_len, use_packed, use_bits, use_rawiq,
                     max_duration_s, max_channels, warm_ephemerides,
                     on_solution):
        """Streaming body of :meth:`process_source`, split out so the
        caller's try/finally can stop the prefetcher on every exit."""
        import os as _os
        import time as _time

        from .utils.metrics import METRICS
        cfg = self.cfg

        with METRICS.stage("receiver.read"):
            first_item = next(blocks, None)
        if first_item is None:
            return ReceiverResult(detections=[], channels=[], solutions=[])
        first = first_item[0]
        if n_samples(first) < self.searcher.block_len:
            # a CONFIG whose chunks can't hold one acquisition block is
            # a caller error; a CAPTURE shorter than one block (now
            # delivered, since sources yield the final partial chunk)
            # is simply empty output — the pre-partial-chunk behavior
            assert chunk_len >= self.searcher.block_len, \
                "chunk_s too small for the acquisition block"
            return ReceiverResult(detections=[], channels=[], solutions=[])

        n_chan = max_channels or cfg.num_chans
        if self.mesh is not None:
            n_dev = self.mesh.shape["dop"]
            assert n_chan % n_dev == 0, (
                f"distributed mode: n_channels ({n_chan}) must divide by "
                f"the mesh device count ({n_dev}); pass max_channels")
        state = tc.init_state(n_chan)
        slot_prns = [None] * n_chan   # channel slot -> PRN (None = free)
        live: dict = {}      # channel slot -> active ChannelRecord
        recs: list = []      # every record ever started (incl. lost)
        t_epoch = p / cfg.fs
        acq_head_len = self.weak_noncoherent * self.searcher.block_len

        def head_of(blk):
            """Acquisition-ready head samples of a host chunk."""
            if use_packed:     # acquisition sees {0,1} samples
                from .io import loaders
                words = blk[: (acq_head_len + 31) // 32]
                return loaders.unpack_1bit(words.tobytes())[:acq_head_len]
            if use_rawiq:      # convert just the head on host
                from .io.loaders import iq8_to_complex
                return iq8_to_complex(
                    blk[: 2 * acq_head_len],
                    signed=source.dtype == "int8",
                    remove_dc=getattr(source, "remove_dc", True))
            return blk[:acq_head_len]

        def start_detections(dets, epoch_searched, epoch_now):
            """Seed channels from detections; fill free slots.

            The ChanStart analog (reference: c/search.cpp:214-238).
            When the search ran on an earlier chunk (async re-acq),
            the code phase is propagated forward at the Doppler-implied
            chip rate — the reference's code-creep correction
            (c/channel.cpp:156-163: ca_shift += round(ca_dop*secs*FS/CPS)).
            """
            nonlocal state
            from .constants import L1_HZ
            if not self._if_offset_locked and dets:
                # one-shot oscillator-offset estimate: sky Doppler is
                # within ~±5 kHz, so a large common component can only
                # be the replay TX/RX offset (README.md §2.1e)
                med = float(np.median([d["doppler_hz"] for d in dets]))
                if abs(med) > 10e3:
                    self._if_offset = med
                self._if_offset_locked = True
            dt = (epoch_now - epoch_searched) * 1e-3
            free = [ch for ch in range(n_chan) if ch not in live]
            tracked = {r.prn for r in live.values()}
            started, seeds = [], []
            for d in sorted(dets, key=lambda x: -x["snr"]):
                if d["prn"] in tracked or not free:
                    continue
                ch = free.pop(0)
                motion_dop = d["doppler_hz"] - self._if_offset
                rate = CHIP_RATE_HZ * (1.0 + motion_dop / L1_HZ)
                code_phase = (d["ca_shift"] * CHIP_RATE_HZ / cfg.fs
                              + rate * dt) % CODE_LEN_CHIPS
                seeds.append((ch, d["doppler_hz"], code_phase,
                              motion_dop))
                slot_prns[ch] = d["prn"]
                rec = ChannelRecord(ch=ch, prn=d["prn"],
                                    start_epoch=epoch_now,
                                    code_phase0=code_phase)
                if warm_ephemerides and d["prn"] in warm_ephemerides:
                    # deep copy: NAV decode mutates the Ephemeris in
                    # place — the caller's checkpoint dict must not be
                    # corrupted by a partial new-IOD ingest, and a lost
                    # + re-acquired PRN must not alias one object
                    import copy
                    rec.eph = copy.deepcopy(warm_ephemerides[d["prn"]])
                live[ch] = rec
                recs.append(rec)
                tracked.add(d["prn"])
                started.append(d)
            if seeds:
                # ONE batched jitted seeding dispatch (the per-channel
                # eager .at[] version costs ~13 dispatches per channel)
                chs, dops_s, cps, mds = zip(*seeds)
                state = tc.start_channels(state, chs, dops_s, cps, mds)
            return started

        def try_acquire(blk, epoch_now):
            """Synchronous search + channel start (cold start path)."""
            if all(ch in live for ch in range(n_chan)):
                return []
            tracked = frozenset(r.prn for r in live.values())
            _tc0 = _time.perf_counter()
            dets = self._cold_detections(head_of(blk),
                                         bits=use_bits or use_packed,
                                         skip_prns=tracked)
            _tc1 = _time.perf_counter()
            started = start_detections(dets, epoch_now, epoch_now)
            if _os.environ.get("TPU_GNSS_TRACE_COLD"):
                print(f"[cold] search {_tc1-_tc0:.2f}s  start_channels "
                      f"{_time.perf_counter()-_tc1:.2f}s", flush=True)
            return started

        with METRICS.stage("receiver.acquire"):
            first_dets = try_acquire(first, 0)
        reacq_base = int(self.reacq_interval_s * 1000)
        reacq_cooldown = reacq_base
        next_reacq = reacq_base

        def drain(pending):
            """Fetch the previous chunk's outputs; bookkeeping + watchdog.

            Runs while the CURRENT chunk computes on device — the host
            side of the pipelining.
            """
            nonlocal state, reacq_cooldown, next_reacq, n_drained
            nonlocal loss_events
            out_fut, snapshot, chunk_ep = pending
            # the blocking fetch absorbs any not-yet-finished device
            # compute plus the device->host copy (a worker thread has
            # been pulling it since dispatch); bookkeeping is timed
            # separately so the two can't be conflated
            with METRICS.stage("receiver.fetch"):
                arr, elp = out_fut.result()      # [5, n_ep, n_chan]
            with METRICS.stage("receiver.drain"):
                ip, qp, cf, caf, cp = arr
                # skip channels the PREVIOUS drain declared lost (their
                # slot was stopped; this chunk's column is post-loss
                # garbage), and copy the column slices — views would pin
                # the whole all-slot chunk buffer for the run's lifetime
                for r in snapshot:
                    if r.lost:
                        continue
                    r.append_hist(np.ascontiguousarray(ip[:, r.ch]),
                                  np.ascontiguousarray(qp[:, r.ch]),
                                  np.ascontiguousarray(cf[:, r.ch]),
                                  np.ascontiguousarray(caf[:, r.ch]),
                                  t_epoch,
                                  cp=np.ascontiguousarray(cp[:, r.ch]))
                    # code-lock detector input: chunk-mean E/L/P mags
                    # (prompt-vs-sides ratio ~2 when the code sits on
                    # the correlation peak, ~1 when it slipped off)
                    e_m, l_m, p_m = (float(elp[0, r.ch]),
                                     float(elp[1, r.ch]),
                                     float(elp[2, r.ch]))
                    side = max(0.5 * (e_m + l_m), 1e-30)
                    r.code_lock = p_m / side
                    r.code_lock_hist.append((r.n_epochs, r.code_lock))
                    if len(r.code_lock_hist) > 4096:   # ~hours of chunks
                        del r.code_lock_hist[:2048]
                # watchdog: free dead channels + their slots (SignalLost)
                self._watchdog([r for r in snapshot if not r.lost])
                stopped = False
                for ch in [c for c, r in live.items() if r.lost]:
                    state = tc.stop_channel(state, ch)
                    slot_prns[ch] = None
                    del live[ch]
                    stopped = True
                if stopped:     # a loss re-arms the search promptly
                    loss_events += 1
                    reacq_cooldown = reacq_base
                    next_reacq = min(next_reacq,
                                     n_dispatched + reacq_base)
                if self.max_history_s is not None:
                    # window must hold whole subframes with margin so
                    # NAV decode inside it stays possible
                    keep = max(int(self.max_history_s * 1000), 12000)
                    for r in recs:
                        if r.lost and (n_dispatched
                                       - (r.start_epoch + r.n_epochs)
                                       > keep):
                            # beyond any future snapshot: drop the
                            # whole history (the record keeps its
                            # anchors/ephemeris; under channel churn
                            # lost records must not leak)
                            r.trim_to(0)
                        elif r.n_epochs - r.trim_epochs > keep:
                            # decode BEFORE the window slides past
                            # undecoded bits (anchors then survive via
                            # the archive)
                            with METRICS.stage("receiver.nav"):
                                self._decode_nav(r)
                            r.trim_to(keep)
                n_drained += chunk_ep

        trace = bool(_os.environ.get("TPU_GNSS_TRACE_CHUNKS"))
        n_dispatched = 0     # epochs sent to the tracker
        n_drained = 0        # epochs whose outputs reached the records
        loss_events = 0      # signal-loss count (re-arm bookkeeping)
        solutions: list = []
        step_ms = int(self.solve_interval_s * 1000)
        next_solve = step_ms

        def instream_solve():
            """Live-mode NAV decode + PVT at the solve cadence."""
            nonlocal next_solve
            while next_solve <= n_drained - 2:
                with METRICS.stage("receiver.nav"):
                    for r in recs:
                        if not r.lost:
                            self._decode_nav(r)
                with METRICS.stage("receiver.solve"):
                    sol = self._solve_at(recs, next_solve)
                if sol is not None:
                    sol.snap_epoch = next_solve
                    solutions.append(sol)
                    on_solution(sol)
                next_solve += step_ms

        # steady-state re-acquisition searches run in a worker thread
        # (the reference's SearchTask coroutine spinning alongside the
        # channel tasks, c/main.cpp:66-68); results are applied at the
        # next chunk boundary with code-creep propagation
        import threading as _threading
        from concurrent.futures import ThreadPoolExecutor
        fetch_pool = ThreadPoolExecutor(max_workers=1)
        reacq_job = None     # {"done", "dets", "epoch", "loss_mark"}

        def launch_reacq(blk, epoch_now):
            tracked = frozenset(r.prn for r in live.values())
            job = {"done": False, "dets": [], "epoch": epoch_now,
                   "loss_mark": loss_events}

            def work():
                try:
                    with METRICS.stage("receiver.acquire"):
                        job["dets"] = self._cold_detections(
                            head_of(blk), bits=use_bits or use_packed,
                            skip_prns=tracked)
                finally:
                    job["done"] = True

            _threading.Thread(target=work, daemon=True).start()
            return job

        # Outstanding chunks before the host drains: depth 2 in batch
        # mode lets the fetch worker finish chunk k-2's download while
        # k-1 computes and k uploads — the main loop then never blocks
        # on a fetch.  Live mode keeps depth 1 so fixes/watchdog lag at
        # most one chunk behind the stream.
        from collections import deque
        depth = 1 if on_solution is not None else 2
        pendings: deque = deque()
        item = first_item
        t_chunk = _time.perf_counter()
        while item is not None:
            blk, seg, n_ep, n_samp = item
            if n_ep == 0:
                break
            tail_ep = n_samp // p - n_ep
            if reacq_job is not None and reacq_job["done"]:
                started = start_detections(reacq_job["dets"],
                                           reacq_job["epoch"],
                                           n_dispatched)
                # fruitless sky searches back off exponentially (a hit
                # or a fresh signal loss resets the cadence); the live
                # SearchEnable loop keeps spinning, just cheaper
                reacq_cooldown = (reacq_base if started
                                  else min(2 * reacq_cooldown,
                                           8 * reacq_base))
                if reacq_job["loss_mark"] == loss_events:
                    next_reacq = n_dispatched + reacq_cooldown
                else:
                    # a channel was lost while this search was in
                    # flight: keep the (sooner) loss re-arm schedule
                    next_reacq = min(next_reacq,
                                     n_dispatched + reacq_cooldown)
                reacq_job = None
            if (reacq_job is None and n_dispatched >= next_reacq
                    and len(live) < n_chan
                    and n_samp >= self.searcher.block_len):
                reacq_job = launch_reacq(blk, n_dispatched)
            tables, code_ffts = self._tables_for(tuple(slot_prns), n_chan)
            with METRICS.stage("receiver.track"):
                if self._tracker_sharded is not None:
                    state, out = self._tracker_sharded(
                        seg, state, tables, code_ffts, self._if_offset)
                else:
                    # exported-program cache: fresh processes skip the
                    # tracker's per-process trace+load (utils.progcache)
                    from .utils import progcache
                    state, out = progcache.call(
                        "track_epochs", tc.track_epochs,
                        args=(seg, state, tables),
                        dyn_kwargs=dict(
                            code_ffts=code_ffts,
                            aid_offset_hz=float(self._if_offset)),
                        static_kwargs=dict(
                            fs=cfg.fs, pll_gains=self.pll_gains,
                            dll_gains=self.dll_gains,
                            epochs_per_step=eps,
                            agc_thresholds=self.agc_thresholds))
                out_dev, elp_dev = _pack_out(out)
                try:
                    # start the device->host copy immediately; the
                    # worker's np.asarray then finds it complete
                    out_dev.copy_to_host_async()
                    elp_dev.copy_to_host_async()
                except Exception:   # backends without async host copies
                    pass
            pendings.append((fetch_pool.submit(
                lambda a=out_dev, b=elp_dev: (np.asarray(a),
                                              np.asarray(b))),
                             list(live.values()), n_ep))
            n_dispatched += n_ep
            while len(pendings) > depth:
                drain(pendings.popleft())
                if on_solution is not None:
                    instream_solve()
            if trace:
                now = _time.perf_counter()
                print(f"[chunk] epochs={n_dispatched} chans={len(live)} "
                      f"dt={now - t_chunk:.2f}s", file=__import__('sys').stderr,
                      flush=True)
                t_chunk = now
            if (max_duration_s is not None
                    and n_dispatched * 1e-3 >= max_duration_s):
                break
            if tail_ep:
                break       # partial final chunk: nothing follows
            with METRICS.stage("receiver.read"):
                item = next(blocks, None)
        while pendings:
            drain(pendings.popleft())
            if on_solution is not None:
                instream_solve()
        fetch_pool.shutdown(wait=False)

        with METRICS.stage("receiver.nav"):
            for r in recs:
                self._decode_nav(r)
        done = {s.snap_epoch for s in solutions}
        snap_epochs = [e for e in range(step_ms, n_dispatched, step_ms)
                       if e not in done]
        if (n_dispatched > 2 and n_dispatched - 2 not in done
                and n_dispatched - 2 not in snap_epochs):
            snap_epochs.append(n_dispatched - 2)
        with METRICS.stage("receiver.solve"):
            for e_snap in snap_epochs:
                sol = self._solve_at(recs, e_snap)
                if sol is not None:
                    sol.snap_epoch = e_snap
                    solutions.append(sol)
                    if on_solution is not None:   # end-of-stream stragglers
                        on_solution(sol)
        solutions.sort(key=lambda s: s.snap_epoch)
        return ReceiverResult(detections=first_dets, channels=recs,
                              solutions=solutions)

    # ------------------------------------------------------------------
    def _transfer(self, blk: np.ndarray, use_bits: bool, sample0: int):
        """One chunk host -> device: bits stay bits, complex quantizes."""
        if use_bits:
            import jax.numpy as jnp
            return self._mix_chunk(
                jnp.asarray(np.ascontiguousarray(blk)), sample0)
        blk = np.ascontiguousarray(blk)
        if self.transfer_dtype == "int2":
            from .utils.xfer import to_device_complex_i2
            return to_device_complex_i2(blk)
        if self.transfer_dtype == "int4":
            from .utils.xfer import to_device_complex_i4
            rms = float(np.sqrt(np.mean(np.abs(blk[:65536]) ** 2)))
            scale = 7.0 / (3.0 * rms) if rms > 1e-12 else 1.0
            return to_device_complex_i4(blk, scale)
        if self.transfer_dtype == "int8":
            from .utils.xfer import to_device_complex_i8
            # per-chunk 6-sigma scale: adapts to level drift and never
            # pins a degenerate scale from a quiet capture start (the
            # dequantize divides it back out on device, and the scale is
            # a traced argument — no retrace on change)
            rms = float(np.sqrt(np.mean(np.abs(blk[:65536]) ** 2)))
            scale = 127.0 / (6.0 * rms) if rms > 1e-12 else 1.0
            try:
                return to_device_complex_i8(blk, scale)
            except Exception as exc:
                # backend without int8 transfer support: fall back once,
                # loudly — a silent downgrade would also mask real bugs
                import sys as _sys
                print(f"tpu_gnss: int8 uplink failed ({exc!r}); "
                      "falling back to float32 planes (4x link traffic)",
                      file=_sys.stderr)
                self.transfer_dtype = "float32"
        from .utils.xfer import to_device_complex
        return to_device_complex(blk)

    # ------------------------------------------------------------------
    def _mix_chunk(self, bits_dev, sample0: int):
        """Device-side quadrature mix of a {0,1} chunk (jitted, cached).

        The LO phase offset for the chunk is reduced on the host in
        float64 (exact for any capture length; an int32 sample counter
        on device would overflow past 2^31 samples).
        """
        import jax.numpy as jnp
        p0 = float((sample0 * float(self.cfg.lo_rate)) % 4.0)
        return _mix_bits_jit(bits_dev, jnp.float32(p0),
                             lo_rate=float(self.cfg.lo_rate))

    # ------------------------------------------------------------------
    def _mix_chunk_packed(self, words: np.ndarray, sample0: int):
        """Device unpack + mix of a packed uint32 word chunk (jitted).

        1 bit/sample crosses the link; LO phase continuity as in
        :meth:`_mix_chunk`.
        """
        import jax.numpy as jnp
        from .ops.onebit import mix_packed
        from .utils import progcache
        p0 = float((sample0 * float(self.cfg.lo_rate)) % 4.0)
        return progcache.call(
            "mix_packed", mix_packed, args=(jnp.asarray(words),),
            dyn_kwargs=dict(phase0_quarters=jnp.float32(p0)),
            static_kwargs=dict(n_bits=32 * len(words),
                               lo_rate=self.cfg.lo_rate))

    # ------------------------------------------------------------------
    def _tables_for(self, slot_key: tuple, n_chan: int):
        """Device code tables + correlator spectra for the slot map.

        Re-uploaded only when the channel->PRN assignment changes — the
        old loop re-transferred the tables every chunk.
        """
        cached = getattr(self, "_tables_cache", None)
        if cached is not None and cached[0] == slot_key:
            return cached[1], cached[2]
        import jax.numpy as jnp
        prns = [prn if prn is not None else 1 for prn in slot_key]
        tables = jnp.asarray(tc.channel_code_tables(prns, n_chan))
        code_ffts = None
        if self.fft_correlator:
            from .utils.xfer import to_device_complex
            spec = tc.code_spectra_np(prns, n_chan, self.cfg.fs)
            code_ffts = to_device_complex(spec)
        self._tables_cache = (slot_key, tables, code_ffts)
        return tables, code_ffts

    # ------------------------------------------------------------------
    def _watchdog(self, recs) -> None:
        """Free channels whose prompt power collapsed (SignalLost analog)
        or that never produced a parity-valid subframe (probation,
        reference: c/channel.cpp:39,343,363 — a false acquisition tracks
        noise at stable power, so the power watchdog alone would let it
        occupy a slot and block its PRN forever)."""
        win = int(self.los_timeout_s * 1000)
        probation = int(self.probation_s * 1000)
        for r in recs:
            if r.lost or r.n_epochs < 2 * win:
                continue
            if (r._decoded_upto >= probation
                    and not r.subframes and not r.archived_subframes):
                r.lost = True
                continue
            if r._ref_pwr is None:
                ref = r.abs_slice("ip", win // 2, win)
                if len(ref) == 0:    # early history already trimmed
                    ref = r.tail("ip", win)
                r._ref_pwr = float(np.mean(np.square(ref)))
            cur = r.tail("ip", win)
            cur_pwr = float(np.mean(np.square(cur)))
            if r._ref_pwr > 0 and cur_pwr < self.los_power_ratio * r._ref_pwr:
                r.lost = True

    def _decode_nav(self, r: ChannelRecord) -> None:
        """(Re-)decode a channel's NAV stream from its prompt history.

        Idempotent: live mode re-runs it as history grows, so the
        subframe list is rebuilt from scratch each call.
        """
        from .track.quality import cn0_nwpr
        ip = r.ip_hist
        # Incremental decode window: the first pass covers everything
        # retained; later passes re-cover a 12 s overlap (two subframes)
        # plus the new epochs, so repeated live-mode decodes cost
        # O(new), not O(total history).  Anchors older than the window
        # survive: a_edge and tow are absolute — archive them first.
        if r._decoded_upto == 0:
            start = r.trim_epochs
        else:
            start = max(r.trim_epochs, r._decoded_upto - 12000)
        skip_abs = max(start, 600)   # skip the pull-in transient
        if r.n_epochs - skip_abs < 40 * CODES_PER_BIT:
            return
        seen = {a["a_edge"] for a in r.archived_subframes}
        for s_old in r.subframes:
            if s_old.get("a_edge") is not None and s_old["a_edge"] not in seen:
                r.archived_subframes.append(s_old)
                seen.add(s_old["a_edge"])
        if len(r.archived_subframes) > 64:   # bound: the transmit-time
            # vote needs a handful of anchors, not a day's worth
            r.archived_subframes = r.archived_subframes[-64:]
        r.subframes = []
        r.last_subframe_bit = None
        r.last_tow = None
        qp = r.qp_hist
        r.cn0_dbhz = cn0_nwpr(ip[-2000:], qp[-2000:])
        # Bit sync on the CODE-PERIOD grid: the NAV bit grid is tied to
        # the tracked chip integral's period index, so every subframe
        # anchor carries an exact edge chip count (a_edge) — immune to
        # the epoch-grid creep that made epoch-based bit offsets slip by
        # a whole period over minutes (see nav/bits.bit_sync_periods).
        ip_s = r.abs_slice("ip", skip_abs, r.n_epochs)
        chips_s = r.abs_slice("chips", skip_abs, r.n_epochs)
        per_s = np.round(np.asarray(chips_s) / CODE_LEN_CHIPS
                         ).astype(np.int64)
        rph = nav_bits.bit_sync_periods(ip_s, per_s)
        r.bit_offset = rph
        bits, b_raw0 = nav_bits.bits_from_prompt_periods(ip_s, per_s, rph)
        r.bits = bits
        frames = nav_bits.frame_sync(bits)
        for f in frames:
            sid = r.eph.ingest(f["data"])
            if sid in (4, 5):
                # collect SV almanac pages (any channel broadcasts the
                # whole constellation's almanac; the reference discards
                # these pages — nav/almanac.py)
                alm = nav_almanac.ingest_page(f["data"])
                if alm is not None and alm.valid():
                    self.almanac[alm.prn] = alm
            # the subframe's first bit starts at this absolute period
            # index -> exact chip count on the channel's integral scale
            start_period = rph + CODES_PER_BIT * (b_raw0 + f["start"])
            a_edge = float(start_period) * CODE_LEN_CHIPS
            # receiver epoch where that bit begins (snapshot gating)
            bit_epoch = (skip_abs
                         + int(np.searchsorted(per_s, start_period)))
            r.subframes.append(dict(sid=sid, tow=r.eph.tow,
                                    bit_epoch=bit_epoch, a_edge=a_edge))
            r.last_subframe_bit = bit_epoch
            r.last_tow = r.eph.tow
        # Hot-start anchors: once the ephemeris is valid (warm start or
        # already decoded), a preamble + parity-valid TLM/HOW pair at
        # the stream tail yields a TOW anchor ~4.8 s before the full
        # subframe completes — the HOW-anchoring trick real receivers
        # use to cut hot time-to-first-fix.  Same (tow, a_edge) anchor
        # convention as full subframes; the solver's cluster vote and
        # RAIM still gate it.
        r.partial_anchors = []
        if r.eph.valid():
            for pa in nav_bits.partial_anchors(bits):
                start_period = rph + CODES_PER_BIT * (b_raw0 + pa["start"])
                a_edge = float(start_period) * CODE_LEN_CHIPS
                bit_epoch = (skip_abs
                             + int(np.searchsorted(per_s, start_period)))
                r.partial_anchors.append(dict(
                    sid="how", tow=pa["tow"],
                    bit_epoch=bit_epoch, a_edge=a_edge))
        r._decoded_upto = r.n_epochs
        if r.eph.valid():
            # a validated ephemeris is strictly better almanac data than
            # the broadcast page — fold it into the store for the next
            # session's directed search
            self.almanac[r.prn] = nav_almanac.Almanac.from_ephemeris(
                r.prn, r.eph)

    def _carrier_smoothed_chips(self, r: ChannelRecord,
                                e_local: int, max_w: int = 20000,
                                settle: int = 1200) -> float:
        """Carrier-smoothed code phase at epoch ``e_local`` (chips).

        Hatch-style smoothing the reference never had: each epoch in a
        trailing window predicts the snapshot's code phase as its own
        tracked chips plus the carrier-implied advance to the snapshot
        (code and carrier are coherent, so the prediction is unbiased
        for any motion/clock dynamics — the advance integrates the
        ACTUAL per-epoch tracked carrier rates); averaging the
        predictions beats the instantaneous DLL estimate by the
        window's independent-sample count.  DLL noise is bandlimited by
        the ~2 Hz loop AND shows multi-second wander events on weak
        channels (r5 soak diagnosis: a lone ~10 m, ~8 s excursion on
        the weakest SV put a 5.9 m spike in an otherwise 1.5 m-median
        series).  The 20 s default window averages those too: swept on
        the 300 s soak scene, max fix error 5.91/3.93/2.58/2.07 m at
        4/10/20/40 s windows with the median flat at ~1.45 m — 20 s
        takes most of the win while keeping the window well under the
        ~100 s real receivers run before code-carrier iono divergence
        (<=~10 cm at typical rates, absent in synthetic scenes)
        matters.  The window skips the pull-in ``settle`` and never
        reaches before channel start; a channel that loses lock stops
        accumulating epochs, so post-loss garbage cannot enter.
        """
        w = min(e_local - settle, max_w, e_local - r.trim_epochs)
        if w < 100:
            return float(r.abs_at("chips", e_local))
        t_epoch = round(self.cfg.fs * 1e-3) / self.cfg.fs
        from .constants import L1_HZ
        caf = np.asarray(r.abs_slice("caf", e_local - w, e_local),
                         np.float64)
        rate = (CHIP_RATE_HZ + caf * (CHIP_RATE_HZ / L1_HZ)) * t_epoch
        tail = np.cumsum(rate[::-1])[::-1]    # advance from epoch i to snap
        implied = (np.asarray(r.abs_slice("chips", e_local - w, e_local),
                              np.float64) + tail)
        return float(implied.mean())

    def _integrity_solve(self, t_tx, ephs, weights):
        """Hard + soft fault-gated position solve.

        Hard layer: :func:`pvt.solve_position_raim` at the gross gate
        (``raim_residual_m``, catches code-period slips ~300 km).  Soft
        layer, calibrated to the receiver's OWN noise: once a residual
        baseline exists (last 32 accepted fixes), a fix whose post-fit
        RMS exceeds 5x the recent median (>=1 m) re-solves with
        exclusion at that threshold — a single glitched pseudorange of
        ~10 m self-flags as a 5-10x residual spike long before the
        gross gate (BENCH_soak300 r4: one 8.5 m fix at resid 2.5 m vs
        a 0.4 m baseline).  The original fix is kept if no subset
        passes, so availability never drops below the hard-gate path.
        """
        sol, excl = pvt.solve_position_raim(
            np.asarray(t_tx), ephs, np.asarray(weights), apply_iono=True,
            residual_gate_m=self.raim_residual_m)
        if sol is None or not sol.converged:
            return None, None
        r_rms = sol.residual_rms_m
        if (excl is None and r_rms is not None
                and len(self._resid_hist) >= 8 and len(t_tx) >= 5):
            soft = max(5.0 * float(np.median(self._resid_hist)), 1.0)
            if r_rms > soft:
                sol2, excl2 = pvt.solve_position_raim(
                    np.asarray(t_tx), ephs, np.asarray(weights),
                    apply_iono=True, residual_gate_m=soft)
                if (sol2 is not None and sol2.converged
                        and excl2 is not None):
                    sol, excl = sol2, excl2
        if sol.residual_rms_m is not None:
            self._resid_hist.append(float(sol.residual_rms_m))
        return sol, excl

    def _solve_at(self, recs, e_snap: int) -> Optional[pvt.Solution]:
        """Assemble a consistent snapshot at epoch ``e_snap`` and solve.

        All channels are sampled at the same receiver epoch — the trivial
        array analog of the reference's spi_hog atomic multi-channel clock
        capture (reference: c/solve.cpp:62-85).

        Channel quality is load-bearing here: the Costas lock detector
        and C/N0 gate solver inclusion (the probation analog,
        reference: c/channel.cpp:39,343,363 — a channel must prove
        itself before the solver trusts it), and the WLS weights are
        C/N0-derived (1/sigma^2 of the DLL thermal noise is
        first-order proportional to linear C/N0) instead of raw prompt
        power.
        """
        from .track.quality import cn0_nwpr, pll_lock_metric
        t_tx, ephs, weights, dops, used = [], [], [], [], []
        for r in recs:
            e_local = e_snap - r.start_epoch  # records may start mid-run
            if (not r.eph.valid()
                    or e_local >= r.n_epochs
                    or e_local <= r.trim_epochs + 1):
                continue
            if self.quality_gate:
                ip_t = r.abs_slice("ip", e_local - 2000, e_local)
                qp_t = r.abs_slice("qp", e_local - 2000, e_local)
                lock = pll_lock_metric(ip_t, qp_t, window=200)
                cn0 = cn0_nwpr(ip_t, qp_t)
                if lock < self.lock_gate:
                    continue
                if cn0 == cn0 and cn0 < self.cn0_gate_dbhz:
                    continue
                cl = r.code_lock_at(e_local)
                if cl is not None and cl < self.code_lock_gate:
                    continue
            subs = {s["a_edge"]: s for s in r.partial_anchors
                    if s.get("a_edge") is not None}
            subs.update({s["a_edge"]: s for s in r.archived_subframes
                         if s.get("a_edge") is not None})
            subs.update({s["a_edge"]: s for s in r.subframes
                         if s.get("a_edge") is not None})
            anchors = [s for s in subs.values()
                       if s["tow"] is not None and s["bit_epoch"] < e_local]
            if not anchors:
                continue
            a_snap = self._carrier_smoothed_chips(r, e_local)
            t = _transmit_time(anchors, a_snap)
            t_tx.append(t)
            ephs.append(r.eph)
            if self.quality_gate:
                # C/N0-derived weight; None (short history) filled with
                # the median below so scales never mix
                weights.append(float(10.0 ** (cn0 / 10.0))
                               if cn0 == cn0 else None)
            else:   # gate off: the reference's prompt-power weighting
                ip = r.abs_slice("ip", e_local - 8, e_local)
                weights.append(float(np.mean(np.square(ip))))
            # carrier Doppler at the snapshot, smoothed over the last
            # 100 ms to average PLL jitter (the loop BW is ~18 Hz)
            cfh = r.abs_slice("caf", e_local - 100, e_local)
            dops.append(float(np.mean(cfh)) if len(cfh) else np.nan)
            used.append(r)
        if len(t_tx) < 4:
            return None
        known = [w for w in weights if w is not None]
        fill = float(np.median(known)) if known else 1.0
        weights = [fill if w is None else w for w in weights]
        # integrity: RAIM fault detection/exclusion — a channel with an
        # inconsistent pseudorange (e.g. a whole-code-period slip,
        # ~300 km) is excluded; with no consistent subset, NO fix is
        # reported rather than a wrong one
        sol, excl = self._integrity_solve(t_tx, ephs, weights)
        if sol is None or not sol.converged:
            return None
        excluded_rec = None
        if excl is not None:
            excluded_rec = (used[excl], t_tx[excl])
            for lst in (t_tx, ephs, weights, dops, used):
                del lst[excl]
        # calendar context for NMEA emission: the subframe-1 week (raw
        # mod-1024; cli.nmea_out resolves it) and the broadcast GPS-UTC
        # leap seconds when any used SV delivered page 18 — so live
        # bursts carry true UTC without the caller re-deriving either
        sol.week = int(ephs[0].week) if ephs else None
        utc_eph = next((e for e in ephs if e.has_utc), None)
        if utc_eph is not None and sol.week is not None:
            from .nav.ephemeris import resolve_week
            sol.leap_s = utc_eph.leap_seconds(
                resolve_week(sol.week), sol.t_rx)
        else:
            sol.leap_s = None
        # satellite view + DOPs for NMEA emission (cli.nmea_out)
        from .cli.nmea_out import sat_geometry
        sv = np.array([e.get_xyz(t) for e, t in zip(ephs, t_tx)])
        elev, az, dop_d = sat_geometry(np.array([sol.x, sol.y, sol.z]), sv)
        sol.dops = dop_d
        sol.sats = [dict(prn=r.prn, elev_deg=float(el), az_deg=float(a),
                         cn0_dbhz=r.cn0_dbhz, used=True)
                    for r, el, a in zip(used, elev, az)]
        if excluded_rec is not None:
            # tracked but excluded by integrity: still in view (GSV),
            # marked unused (GSA filters on the flag)
            r_x, t_x = excluded_rec
            el_x, az_x, _ = sat_geometry(
                np.array([sol.x, sol.y, sol.z]),
                np.array([r_x.eph.get_xyz(t_x)]))
            sol.sats.append(dict(prn=r_x.prn, elev_deg=float(el_x[0]),
                                 az_deg=float(az_x[0]),
                                 cn0_dbhz=r_x.cn0_dbhz, used=False))
        # Doppler velocity solve at the converged position (VTG analog;
        # beyond the reference, which never computes velocity)
        # the tracked carrier frequency minus the receiver-applied IF
        # offset is the motion Doppler solve_velocity expects; residual
        # estimate error lands in its clock-drift unknown
        dops = np.asarray(dops) - self._if_offset
        if np.all(np.isfinite(dops)):
            try:
                sol.vel = pvt.solve_velocity(
                    np.array([sol.x, sol.y, sol.z]), sol.t_rx,
                    np.asarray(t_tx), ephs, dops, np.asarray(weights))
            except np.linalg.LinAlgError:
                pass
        return sol


def _transmit_time(anchors, a_snap: float) -> float:
    """Anchor-voted transmit time (SV seconds of week) at the snapshot.

    Each decoded subframe is an independent anchor: its TOW names an
    absolute transmit time, and the chip count at its first bit edge is
    (nearly) a whole number of code periods, so
    ``t = (tow-1)*6 + (a_snap - n_per*1023)/chip_rate``
    (reference transmit-time arithmetic, c/solve.cpp:118-133).

    Each anchor carries its exact edge chip count ``a_edge`` from the
    period-grid bit sync (nav/bits.bit_sync_periods) — no per-anchor
    rounding, so all anchors of a channel agree by construction.  The
    1 ms cluster vote is kept as a safety net (a bit-sync phase change
    between decode passes, an anchor decoded from a corrupted stretch),
    and the median inside the winning cluster averages per-anchor chip
    noise.  (The naive form — rounding the chip integral at the
    DETECTED EPOCH to a whole period — slipped by one period when code
    creep walked the epoch grid across the period grid: a ±300 km
    pseudorange error that only minutes-long soaks exposed.)
    """
    cands = np.array(
        [(s["tow"] - 1) * 6.0 + (a_snap - s["a_edge"]) / CHIP_RATE_HZ
         for s in anchors])
    ref = np.round((cands - cands[0]) / 1e-3)
    vals, counts = np.unique(ref, return_counts=True)
    pick = vals[np.argmax(counts)]
    return float(np.median(cands[ref == pick]))


def _mix_bits_jit(bits_dev, p0, *, lo_rate: float):
    """Module-level jitted quadrature mix (shared across Receiver
    instances — a per-instance lambda would re-trace every run)."""
    global _MIX_JIT
    try:
        fn = _MIX_JIT
    except NameError:
        import functools
        import jax
        from .acquire.search import mix_baseband

        @functools.partial(jax.jit, static_argnames=("lo_rate",))
        def fn(b, p, *, lo_rate):
            return mix_baseband(b, lo_rate, phase0_quarters=p)
        _MIX_JIT = fn
    return fn(bits_dev, p0, lo_rate=lo_rate)


_PACK_FN = None


def _pack_out(out: tc.EpochOut):
    """Pack per-epoch planes + per-chunk E/L/P magnitude means.

    One device->host fetch per chunk: the five [n_ep, n_chan] planes
    the host bookkeeping needs (incl. the device code phase that
    anchors the transmit-time chip integral), plus a tiny [3, n_chan]
    chunk-mean of
    |early|, |late|, |prompt| — enough for the code-lock detector
    (track/quality.code_lock_metric) without shipping the full E/L
    histories (they would add 50% to the link traffic for a statistic
    that is only ever windowed).
    """
    global _PACK_FN
    if _PACK_FN is None:
        import jax
        import jax.numpy as jnp

        def pack(o):
            planes = jnp.stack(
                [o.ip, o.qp, o.code_dev, o.carrier_freq, o.code_phase]
            ).astype(jnp.float32)
            p_mag = jnp.sqrt(o.ip * o.ip + o.qp * o.qp)
            elp = jnp.stack([o.e_mag.mean(0), o.l_mag.mean(0),
                             p_mag.mean(0)]).astype(jnp.float32)
            return planes, elp
        _PACK_FN = jax.jit(pack)
    return _PACK_FN(out)
