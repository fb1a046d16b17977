"""Full-scale end-to-end test: real 20 ms nav bits, position fix.

~29 s of 4-satellite IQ at 2.046 MHz with geometrically consistent
delays derived from a planted receiver position — the complete
BASELINE.json pipeline through to a PVT solution.  Takes ~1 min on the
CPU test mesh, so it is gated behind RUN_SLOW=1 (chip_smoke.py phase 3
runs the same flow, with all 32 PRNs searched, on a GPU).
"""

import os

import numpy as np
import pytest

slow = pytest.mark.skipif(
    os.environ.get("RUN_SLOW") != "1", reason="set RUN_SLOW=1 to run"
)

from stm32f4_sdr_gps_tpu.config import (
    COHERENT_TRACK,
    DEEP_ACQ,
    ReceiverConfig,
)
from stm32f4_sdr_gps_tpu.runtime.receiver import Receiver
from stm32f4_sdr_gps_tpu.signal.scenarios import fix_scenario


@slow
def test_full_cold_start_to_fix():
    # 2s run-in + 5 subframes (30s) incl. margin for the post-decode solve
    sc = fix_scenario(num_epochs=29_000)
    cfg = ReceiverConfig(prns=sc.prns, track_block_epochs=1000)
    rx = Receiver(cfg)
    report = rx.run(sc.samples)
    for ch in report.channels:
        assert ch.eph.has_full_set, ch.prn
    assert report.solutions, "no position fix obtained"
    sol = report.solutions[-1]
    err = np.linalg.norm(sol.rr - sc.rr_true)
    # relative pseudoranges carry tracking noise (~0.05 chip ≈ 15 m UERE)
    assert err < 500.0, f"position error {err:.1f} m"
    # velocity solution: static receiver, so ~0 (vel noise scales with
    # Doppler tracking noise x GDOP)
    assert sol.vel is not None
    assert np.linalg.norm(sol.vel) < 10.0


@slow
def test_weak_signal_cold_start_to_fix_32dbhz():
    """The full weak-signal chain at 32 dBHz: DEEP_ACQ acquisition ->
    256-epoch fine Doppler + 100-epoch pre-track handoff -> aided
    histogram bit sync -> 20 ms coherent PLL -> ephemeris decode ->
    fix.  The stock/firmware path cannot decode nav data below
    ~42 dBHz (see PARITY.md); measured floor for this chain is
    ~30 dBHz (fix at 30/31/32 across seeds)."""
    sc = fix_scenario(num_epochs=36_000, cn0_dbhz=32.0)
    cfg = ReceiverConfig(prns=sc.prns, acq=DEEP_ACQ,
                         track=COHERENT_TRACK, track_block_epochs=1000)
    rx = Receiver(cfg)
    report = rx.run(sc.samples)
    for ch in report.channels:
        assert ch.eph.has_full_set, ch.prn
        assert ch.bit_synced
    assert report.solutions, "no position fix obtained"
    err = np.linalg.norm(report.solutions[-1].rr - sc.rr_true)
    assert err < 500.0, f"position error {err:.1f} m"


@slow
def test_weak_signal_cold_start_to_fix_29dbhz():
    """The round-3 deep chain at 29 dBHz: ULTRA_ACQ acquisition ->
    aided bit sync -> 100 ms data-wipeoff PLL (DEEP_COHERENT_TRACK) ->
    ephemeris decode over a 66 s capture with the real 30 s frame
    rebroadcast -> fix.  Measured floor: fix on 3/3 seeds at 29 dBHz
    (194-260 m); at 28 one satellite typically misses a subframe
    (tools/deep_cold_probe.py)."""
    from stm32f4_sdr_gps_tpu.config import DEEP_COHERENT_TRACK, ULTRA_ACQ

    sc = fix_scenario(num_epochs=66_000, cn0_dbhz=29.0, frame_repeats=2)
    cfg = ReceiverConfig(prns=sc.prns, acq=ULTRA_ACQ,
                         track=DEEP_COHERENT_TRACK, track_block_epochs=1000)
    rx = Receiver(cfg)
    report = rx.run(sc.samples)
    for ch in report.channels:
        assert ch.eph.has_full_set, ch.prn
        assert ch.bit_synced
    assert report.solutions, "no position fix obtained"
    err = np.linalg.norm(report.solutions[-1].rr - sc.rr_true)
    assert err < 500.0, f"position error {err:.1f} m"


@slow
def test_cold_start_fix_under_rf_impairments():
    """Cold start to fix on an RF-impaired capture (VERDICT r2
    §missing-3 done-condition): ±2 ppm TCXO offset (∓3.15 kHz common
    carrier shift + code-rate scaling), 0.003 ppm/s drift (~4.7 Hz/s
    common chirp), 0.5 rad²/s oscillator phase noise, 1.8 MHz front-end
    band-limiting, and 0.8-chip/0.3-amp two-ray multipath on two
    satellites.  Documented tolerance: the multipath biases the two
    affected pseudoranges by up to ~60 m, so the fix bound is 700 m
    (clean-capture bound is 500 m)."""
    from stm32f4_sdr_gps_tpu.signal.simulator import Impairments

    imp = Impairments(
        tcxo_offset_ppm=-2.0,
        tcxo_drift_ppm_s=0.003,
        phase_noise_rad2_s=0.5,
        frontend_bw_hz=1.8e6,
    )
    sc = fix_scenario(
        num_epochs=29_000,
        impairments=imp,
        multipath={2: (0.8, 0.3, 0.13), 15: (0.9, 0.3, 0.77)},
    )
    cfg = ReceiverConfig(prns=sc.prns, track_block_epochs=1000)
    rx = Receiver(cfg)
    report = rx.run(sc.samples)
    for ch in report.channels:
        assert ch.eph.has_full_set, ch.prn
    assert report.solutions, "no position fix under impairments"
    err = np.linalg.norm(report.solutions[-1].rr - sc.rr_true)
    assert err < 700.0, f"position error {err:.1f} m"
