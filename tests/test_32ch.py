"""BASELINE configs 2 & 5: 32-PRN cold start and streaming mesh receiver."""

import jax
import numpy as np
import pytest

from stm32f4_sdr_gps_tpu.config import AcqConfig, BASEBAND_PLAN, TrackConfig
from stm32f4_sdr_gps_tpu.parallel.mesh import make_mesh
from stm32f4_sdr_gps_tpu.parallel.streaming import (
    StreamingTracker,
    acquire_sharded,
)
from stm32f4_sdr_gps_tpu.signal.ca_code import ca_table_bipolar
from stm32f4_sdr_gps_tpu.signal.simulator import SimSat, simulate_capture
from stm32f4_sdr_gps_tpu.track.state import init_state

PLAN = BASEBAND_PLAN

PRESENT = {
    2: (-3800.0, 130.0), 5: (-2100.0, 700.2), 9: (-600.0, 303.3),
    13: (450.0, 911.7), 17: (1800.0, 401.1), 21: (3300.0, 55.5),
    26: (5200.0, 840.0), 30: (6600.0, 222.2),
}


@pytest.fixture(scope="module")
def capture():
    sats = [
        SimSat(prn=p, doppler_hz=d, code_phase_chips=c, cn0_dbhz=44.0)
        for p, (d, c) in PRESENT.items()
    ]
    x, truth = simulate_capture(sats, num_epochs=60, seed=9)
    return x, truth, sats


def test_cold_start_all_32_prns_sharded(capture):
    """All 32 PRNs x full +/-7 kHz grid, PRNs sharded over the mesh:
    exactly the 8 present satellites detected, none of the other 24."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    x, truth, sats = capture
    mesh = make_mesh(time=2, chan=4)
    results = acquire_sharded(x, range(1, 33), mesh, PLAN, AcqConfig())
    assert len(results) == 32
    by = {r.prn: r for r in results}
    for prn, (dop, cp) in PRESENT.items():
        r = by[prn]
        assert r.detected, prn
        assert abs(r.doppler_hz - dop) < 250.0, prn
        err = (r.code_phase_chips - cp + 511.5) % 1023 - 511.5
        assert abs(err) < 0.7, (prn, err)  # half-chip grid + interp
    false_alarms = [r.prn for r in results
                    if r.detected and r.prn not in PRESENT]
    assert not false_alarms, false_alarms


def test_streaming_tracker_32_channels(capture):
    """32 channels (8 real + 24 ghost PRNs) sharded over the mesh,
    fed block-by-block; real channels stay locked, state persists
    across blocks."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    x, truth, sats = capture
    mesh = make_mesh(time=2, chan=4)
    prns = list(range(1, 33))
    table = ca_table_bipolar(prns)
    cp0 = np.array([PRESENT.get(p, (0.0, 500.0))[1] for p in prns])
    dop0 = np.array([PRESENT.get(p, (0.0, 0.0))[0] for p in prns])
    state = init_state(32, cp0 + 0.1, dop0 + 20.0)
    tracker = StreamingTracker(state, table, mesh, PLAN, TrackConfig())

    spe = PLAN.samples_per_epoch
    outs_list = [tracker.process(x[i * 20 * spe: (i + 1) * 20 * spe])
                 for i in range(3)]
    dop = np.concatenate([np.asarray(o.doppler_hz) for o in outs_list])
    assert dop.shape == (60, 32)
    for ci, p in enumerate(prns):
        if p in PRESENT:
            want = PRESENT[p][0]
            assert abs(np.mean(dop[-10:, ci]) - want) < 30.0, p


def test_mesh_receiver_end_to_end():
    """Full receiver with mesh-sharded acquisition + channel-sharded
    tracking (BASELINE config 5 single-controller shape): decodes the
    same ephemerides as the plain receiver."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from stm32f4_sdr_gps_tpu.config import ReceiverConfig, TrackConfig
    from stm32f4_sdr_gps_tpu.runtime.mesh_receiver import MeshReceiver

    from tests.test_receiver import _make_capture, PRNS, CIB

    num_epochs = 120 * CIB + 4 * 300 * CIB + 400
    x, _ = _make_capture(num_epochs, seed=11)
    cfg = ReceiverConfig(
        prns=PRNS,
        track=TrackConfig(codes_in_bit=CIB, pll_bad_state_threshold=10**9),
        enable_position=False,
        track_block_epochs=500,
    )
    mesh = make_mesh(time=2, chan=4)
    rx = MeshReceiver(cfg, mesh)
    report = rx.run(x)
    assert len(report.channels) == 4
    for ch in report.channels:
        assert ch.state_name == "TRACKING"
        assert (ch.eph.received_mask_proc & 0x7) == 0x7, ch.prn


def test_mesh_receiver_aided_sync_engages():
    """Aided bit sync on the mesh path: COHERENT_TRACK disables the
    run-time counters, so sync can only come from the histogram search
    acting on the SHARDED tracking state (Receiver._maybe_aided_sync
    via MeshReceiver.process_block)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from stm32f4_sdr_gps_tpu.config import COHERENT_TRACK, ReceiverConfig
    from stm32f4_sdr_gps_tpu.runtime.mesh_receiver import MeshReceiver
    from stm32f4_sdr_gps_tpu.signal.simulator import SimSat, simulate_capture

    rng = np.random.default_rng(2)
    prns = (5, 29)
    sats = [SimSat(prn=p, doppler_hz=float(d), code_phase_chips=float(cp),
                   cn0_dbhz=45.0, codes_in_bit=20,
                   nav_bits=list(rng.integers(0, 2, 40)))
            for p, d, cp in zip(prns, (900.0, -1400.0), (100.0, 700.0))]
    E = 4800
    x, _ = simulate_capture(sats, num_epochs=E, seed=2)

    cfg = ReceiverConfig(prns=prns, track=COHERENT_TRACK,
                         enable_position=False, track_block_epochs=100)
    # a 2-device mesh exercises the same sharded digest/aided-sync path
    # as 8 at a quarter of the virtual-device core oversubscription
    # (this test was the suite's slowest at 8: the 4.8 s coherent run
    # costs ~10 min under CI contention, ~2 min at 2 devices)
    mesh = make_mesh(time=1, chan=2, devices=jax.devices()[:2])
    rx = MeshReceiver(cfg, mesh)
    report = rx.run(x)
    for ch in report.channels:
        assert ch.bit_synced, ch.prn
        assert ch.bit_count > 5, ch.prn


def test_mesh_receiver_late_rise_and_drop():
    """Dynamic channel set on the mesh: a PRN absent at cold start rises
    mid-capture and joins via background re-acquisition
    (reacquire_period_ms), with the device digest ACTIVE — the base
    Receiver's maybe_reacquire/drop_dead_channels run on the un-padded
    live state and the result is re-padded + re-sharded
    (MeshReceiver._sync_live_from_tracker/_reshard_to_tracker)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from stm32f4_sdr_gps_tpu.config import ReceiverConfig
    from stm32f4_sdr_gps_tpu.runtime.mesh_receiver import MeshReceiver
    from stm32f4_sdr_gps_tpu.signal.simulator import SimSat, simulate_capture

    CIB = 3
    E = 3000
    rise_epoch = 1200
    sat_a = SimSat(prn=5, doppler_hz=1200.0, code_phase_chips=300.0,
                   cn0_dbhz=47.0, codes_in_bit=CIB)
    sat_b = SimSat(prn=18, doppler_hz=-2400.0, code_phase_chips=700.0,
                   cn0_dbhz=47.0, codes_in_bit=CIB)
    xa, _ = simulate_capture([sat_a], num_epochs=E, seed=31)
    xb, truth_b = simulate_capture([sat_b], num_epochs=E, seed=32)
    spe = PLAN.samples_per_epoch
    xb[: rise_epoch * spe] = 0
    x = xa + xb

    cfg = ReceiverConfig(
        prns=(5, 18),
        track=TrackConfig(codes_in_bit=CIB, pll_bad_state_threshold=10**9),
        enable_position=False,
        track_block_epochs=250,
        reacquire_period_ms=500,
        device_digest=True,
    )
    mesh = make_mesh(time=2, chan=4)
    rx = MeshReceiver(cfg, mesh)
    assert rx._digest_active
    report = rx.run(x)
    by = {ch.prn: ch for ch in report.channels}
    assert 5 in by and by[5].state_name == "TRACKING"
    assert 18 in by, "late riser was never added on the mesh"
    assert by[18].state_name == "TRACKING"
    assert abs(by[18].doppler_hz + 2400.0) < 15.0
    cp_true = truth_b.code_phase_at_epoch(0, report.epochs_processed - 1)
    err = (by[18].code_phase_chips - cp_true + 511.5) % 1023 - 511.5
    assert abs(err) < 0.5
    assert not rx.standby_channels
    # the tracker state must remain mesh-padded and sharded
    n_dev = mesh.devices.size
    n_tracked = int(rx.tracker.code_table.shape[0])
    assert n_tracked % n_dev == 0 and rx._n_live == 2


def test_streaming_tracker_rejects_indivisible_channels():
    """A channel count that does not divide over the mesh fails with an
    explanatory error, not a cryptic shard_map partitioning error."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = make_mesh(time=2, chan=4)
    table = ca_table_bipolar([1, 2, 3])
    state = init_state(3, np.zeros(3), np.zeros(3))
    with pytest.raises(ValueError, match="3 channels do not divide"):
        StreamingTracker(state, table, mesh, PLAN, TrackConfig())
