"""End-to-end receiver pipeline test (compressed-time).

Runs the full chain — acquisition → pre-track → tracking scan → bit
sync → framing → parity → ephemeris decode → pseudorange formation — on
a 4-satellite capture with physically consistent per-satellite delays.
Nav bits are compressed to 3 code periods per bit so three full
subframes fit in ~3 s of signal (the real-time 20 ms/bit configuration
is exercised by tests/test_e2e_slow.py).
"""

import numpy as np
import pytest

from stm32f4_sdr_gps_tpu.config import (
    AcqConfig,
    CLIGHT,
    ReceiverConfig,
    TrackConfig,
)
from stm32f4_sdr_gps_tpu.pvt.observables import form_observations, ChannelObservables
from stm32f4_sdr_gps_tpu.runtime.receiver import Receiver
from stm32f4_sdr_gps_tpu.signal.nav_message import build_bitstream
from stm32f4_sdr_gps_tpu.signal.simulator import SimSat, simulate_capture

from tests.test_nav import TEST_EPH

CIB = 3  # compressed codes-per-bit

PRNS = (2, 7, 15, 24)
DELAYS_MS = (1.773, 6.402, 3.255, 9.911)
DOPPLERS = (-2500.0, 800.0, 3100.0, -400.0)


def _make_capture(num_epochs, seed=11):
    prefix = np.tile([0, 1], 60).astype(np.int8)  # fast bit-sync run-in
    sats = []
    for prn, delay, dop in zip(PRNS, DELAYS_MS, DOPPLERS):
        eph = dict(TEST_EPH)
        # leading subframe 5 is sacrificial: its preamble resolves the
        # 180-degree polarity ambiguity before subframes 1-3 arrive
        body = build_bitstream(eph, start_tow_6s=58800, num_subframes=4,
                               subframe_ids=(5, 1, 2, 3))
        bits = np.concatenate([prefix, body])
        sats.append(
            SimSat(
                prn=prn,
                doppler_hz=dop,
                cn0_dbhz=49.0,
                nav_bits=bits,
                codes_in_bit=CIB,
                delay_ms=delay,
            )
        )
    return simulate_capture(sats, num_epochs=num_epochs, seed=seed)


@pytest.fixture(scope="module")
def report_and_receiver():
    # prefix 120 bits + 4 subframes * 300 bits * 3 ms + margin
    num_epochs = 120 * CIB + 4 * 300 * CIB + 400
    x, truth = _make_capture(num_epochs)
    cfg = ReceiverConfig(
        prns=PRNS,
        acq=AcqConfig(),
        track=TrackConfig(codes_in_bit=CIB, pll_bad_state_threshold=10**9),
        enable_position=False,     # solve covered by unit + slow e2e tests
        track_block_epochs=250,
    )
    rx = Receiver(cfg)
    report = rx.run(x)
    return report, rx, truth


def test_all_channels_acquired_and_tracked(report_and_receiver):
    report, rx, truth = report_and_receiver
    assert len(report.channels) == 4
    for ch, dop in zip(report.channels, DOPPLERS):
        assert ch.state_name == "TRACKING"
        assert abs(ch.doppler_hz - dop) < 10.0
        assert ch.snr_db > 5.0


def test_subframes_decoded_on_all_channels(report_and_receiver):
    report, _, _ = report_and_receiver
    for ch in report.channels:
        assert ch.subframe_count >= 3, ch.prn
        assert ch.eph.has_full_set, ch.prn
        assert ch.eph.week == TEST_EPH["week"]
        assert abs(ch.eph.A - TEST_EPH["A"]) < 1.0
        assert abs(ch.eph.M0 - TEST_EPH["M0"]) < 1e-8
        assert abs(ch.eph.e - TEST_EPH["e"]) < 1e-9


def test_relative_pseudoranges_match_planted_delays(report_and_receiver):
    report, rx, truth = report_and_receiver
    meas_ms = report.epochs_processed - 1
    chobs = [
        ChannelObservables(
            prn=ch.prn,
            subframe_time_ms=ch.subframe_time_ms,
            tow_s=ch.subframe_tow_s,
            week=ch.eph.week,
            code_phase_chips=ch.code_phase_chips,
            doppler_hz=ch.doppler_hz,
            snr_db=ch.snr_db,
        )
        for ch in report.channels
    ]
    obs = form_observations(chobs, meas_ms)
    assert obs is not None
    ref = int(np.argmin(DELAYS_MS))
    pr = np.array([o.P for o in obs])
    want_rel = (np.array(DELAYS_MS) - DELAYS_MS[ref]) * CLIGHT / 1000.0
    got_rel = pr - pr[ref]
    # code Doppler drifts the true relative TOF over the capture; the
    # tracked code phase follows it, so compare against the *current*
    # relative delays from simulator truth.
    # delay_eff(t) = delay - (fd/fL1)*t (code Doppler shortens/stretches
    # the received code relative to the nominal ms grid)
    drift_ms = np.array([
        -(DOPPLERS[i] / 1.57542e9) * meas_ms for i in range(4)
    ])
    want_rel_now = want_rel + (drift_ms - drift_ms[ref]) * CLIGHT / 1000.0
    err_m = got_rel - want_rel_now
    assert np.max(np.abs(err_m - err_m[ref])) < 25.0, err_m


def test_subframe_times_consistent(report_and_receiver):
    report, _, _ = report_and_receiver
    # all channels framed the same subframe boundary within TOF spread
    times = np.array([ch.subframe_time_ms for ch in report.channels])
    assert times.max() - times.min() <= np.ceil(max(DELAYS_MS)) + 1
    tows = {ch.subframe_tow_s for ch in report.channels}
    assert len(tows) == 1  # same boundary label on every channel
