"""Long-capture soak: continuous operation through signal loss.

The reference's live rig runs continuously — channels die (antenna
blockage), the watchdog frees them, the search re-acquires, and the
solver keeps producing a fix every 4 s throughout
(reference: c/channel.cpp:211-254 SignalLost, c/solve.cpp:300).  This
test streams a long 1-bit capture with a mid-run SV dropout through the
full chain at bounded memory and asserts all of that end to end.

The on-device analog (>= 60 s on the GPU, with RSS tracking) is
tools/soak_payload.py, which shares this scene recipe.
"""

import numpy as np
import pytest

from tpu_gnss.config import ReceiverConfig
from tpu_gnss.io import loaders
from tpu_gnss.io.stream import FileSource1Bit
from tpu_gnss.receiver import Receiver
from tpu_gnss.signal.synth import baseband_to_1bit_if

from .test_e2e import FS, TRUTH_LLA, build_scene, eph_prn

DURATION = 32.0
DROP_SV = 0                      # constellation index -> PRN 2
DROP_T0, DROP_T1 = 8.0, 14.0     # blockage window (receiver seconds)


@pytest.mark.slow
def test_soak_dropout_reacquire_fix_cadence(tmp_path):
    iq, ephs, rx = build_scene(duration=DURATION,
                               dropout=(DROP_SV, DROP_T0, DROP_T1))
    fc = FS / 4
    path = tmp_path / "soak_1bit.bin"
    path.write_bytes(loaders.pack_1bit(baseband_to_1bit_if(iq, fc, FS)))
    del iq

    cfg = ReceiverConfig(fs=FS, fc=fc, max_fo=5000.0, fft_len=4096,
                         snr_threshold=17.0)
    recv = Receiver(cfg)
    res = recv.process_source(FileSource1Bit(str(path), cfg), chunk_s=1.0)

    prn = eph_prn(DROP_SV)
    drop_recs = [r for r in res.channels if r.prn == prn]

    # 1. the blocked SV was tracked, then declared lost by the watchdog
    #    within ~los_timeout of the dropout (not at EOF, not never)
    assert drop_recs, f"PRN {prn} never acquired"
    first = drop_recs[0]
    assert first.lost, f"PRN {prn} dropout never triggered the watchdog"
    t_lost = (first.start_epoch + first.n_epochs) * 1e-3
    assert DROP_T0 < t_lost < DROP_T1, \
        f"lost at {t_lost:.1f}s, dropout was [{DROP_T0},{DROP_T1})s"

    # 2. the freed slot was re-acquired once the signal returned
    assert len(drop_recs) >= 2, f"PRN {prn} never re-acquired"
    second = drop_recs[1]
    assert second.start_epoch * 1e-3 >= DROP_T1, \
        f"re-acquired at {second.start_epoch*1e-3:.1f}s, before signal return"
    assert not second.lost
    assert second.n_epochs >= 5000, "re-acquired channel did not hold lock"

    # 3. fix cadence: every 4 s snapshot from the first fix to the end
    #    produced a converged solution — including through the dropout
    assert res.solutions, "no fixes at all"
    snap_s = [s.snap_epoch * 1e-3 for s in res.solutions]
    first_fix = snap_s[0]
    expected = [t for t in np.arange(4.0, DURATION - 1.0, 4.0)
                if t >= first_fix]
    missing = sorted(set(np.round(expected, 3))
                     - set(np.round(snap_s, 3)))
    assert not missing, f"missed 4 s fix slots at {missing} (got {snap_s})"
    assert first_fix <= 8.0, f"first fix only at {first_fix:.0f}s"

    # 4. accuracy holds through the soak (1-bit front end)
    errs = [np.linalg.norm(np.array([s.x, s.y, s.z]) - np.array(rx))
            for s in res.solutions]
    # r4: the chip integral is anchored to the device code phase and
    # soft-RAIM excludes residual-flagged glitches — errors stay at
    # the few-meter level with NO growth (300 s hardware soak: worst
    # 2.2 m).  Lock the regression well below the old 8 m drift.
    assert max(errs) < 4.0, f"worst fix error {max(errs):.1f} m"

    # 5. bounded memory: retained per-channel state is the integrate-and-
    #    dump product (kB/s scale), not raw samples (MB/s scale)
    hist_bytes = sum(arr.nbytes for r in res.channels
                     for parts in r._chunks.values() for arr in parts)
    n_epochs_total = sum(r.n_epochs for r in res.channels)
    assert hist_bytes < 64 * n_epochs_total + 1e6, \
        f"history {hist_bytes/1e6:.1f} MB is not O(epochs)"
