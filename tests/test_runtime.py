"""Runtime capabilities: checkpoint/resume, warm reset, RTCM emission."""

import numpy as np
import pytest

from stm32f4_sdr_gps_tpu.config import ReceiverConfig, TrackConfig
from stm32f4_sdr_gps_tpu.io.rtcm3 import decode_1019, decode_msm, deframe
from stm32f4_sdr_gps_tpu.runtime.checkpoint import load_receiver, save_receiver
from stm32f4_sdr_gps_tpu.runtime.receiver import Receiver
from stm32f4_sdr_gps_tpu.signal.simulator import SimSat, simulate_capture

from tests.test_receiver import CIB, DELAYS_MS, DOPPLERS, PRNS, _make_capture


@pytest.fixture(scope="module")
def short_capture():
    return _make_capture(1200, seed=13)


def _cfg(**kw):
    base = dict(
        prns=PRNS,
        track=TrackConfig(codes_in_bit=CIB, pll_bad_state_threshold=10**9),
        enable_position=False,
        track_block_epochs=200,
    )
    base.update(kw)
    return ReceiverConfig(**base)


def test_checkpoint_resume_bit_exact(tmp_path, short_capture):
    """Stop mid-capture, checkpoint, resume in a new receiver: outputs
    must equal an uninterrupted run (SURVEY.md §5 checkpoint/resume)."""
    x, _ = short_capture
    spe = 2046

    rx_full = Receiver(_cfg())
    rx_full.run(x)

    rx_a = Receiver(_cfg())
    cut = 600
    rx_a.acquire_all(x)
    acq_e = rx_a.config.acq.noncoherent_epochs
    rx_a.start_tracking(x[acq_e * spe:], start_epoch=acq_e)
    rx_a.epoch_cursor = acq_e
    pos = acq_e * spe
    while rx_a.epoch_cursor < cut:
        rx_a.process_block(x[pos: pos + 200 * spe])
        pos += 200 * spe
    path = str(tmp_path / "ckpt.npz")
    save_receiver(path, rx_a)

    rx_b = load_receiver(path)
    assert rx_b.epoch_cursor == rx_a.epoch_cursor
    while pos + spe <= len(x):
        chunk = x[pos: pos + 200 * spe]
        if len(chunk) < spe:
            break
        rx_b.process_block(chunk)
        pos += (len(chunk) // spe) * spe

    for ch_f, ch_b in zip(rx_full.channels, rx_b.channels):
        assert ch_f.prn == ch_b.prn
        assert abs(ch_f.code_phase_chips - ch_b.code_phase_chips) < 1e-3
        assert abs(ch_f.doppler_hz - ch_b.doppler_hz) < 1e-2
        assert ch_f.bit_count == ch_b.bit_count


def test_warm_reset_preserves_doppler():
    """Warm reset re-acquires code phase with the learned Doppler as
    hint and keeps tracking (gps_master.c:490-510 capability)."""
    # long enough that even inverted-polarity channels decode words
    # (polarity needs two subframe-aligned TLM sightings)
    x, truth = _make_capture(2300, seed=13)
    rx = Receiver(_cfg())
    rx.run(x)
    doppler_before = {ch.prn: ch.doppler_hz for ch in rx.channels}
    # enough words decoded for the hint path on at least some channels
    assert any(ch.framer.words_decoded > 1 for ch in rx.channels)

    rx.warm_reset(x[-400 * 2046:])
    assert all(ch.state_name == "TRACKING" for ch in rx.channels)
    for ch in rx.channels:
        assert abs(ch.acq.doppler_hz - doppler_before[ch.prn]) < 300.0


def test_receiver_emits_rtcm(short_capture):
    x, _ = _make_capture(4400, seed=13)
    rx = Receiver(_cfg(enable_rtcm=True))
    rx.run(x)
    assert rx.rtcm_frames, "no RTCM frames emitted"
    kinds = []
    for f in rx.rtcm_frames:
        payload = deframe(f)
        assert payload is not None, "bad frame CRC"
        msg = (payload[0] << 4) | (payload[1] >> 4)
        kinds.append(msg)
        if msg == 1019:
            d = decode_1019(payload)
            assert d["sat"] in PRNS
        elif msg == 1075:
            d = decode_msm(payload)
            assert {o["sat"] for o in d["obs"]} <= set(PRNS)
    assert 1019 in kinds
    assert 1075 in kinds


def test_boundary_dejitter():
    """An isolated +/-1 epoch bit-edge slip is snapped back to the
    channel's nav-bit grid once 3 detections exist."""
    from stm32f4_sdr_gps_tpu.runtime.receiver import ChannelStatus, Receiver

    ch = ChannelStatus(prn=1)
    cib = 20
    seq_in = [6007, 12007, 18008, 24007, 30006, 36007]  # slips at 3rd/5th
    out = [Receiver._dejitter_boundary(ch, b, cib) for b in seq_in]
    assert out[0] == 6007 and out[1] == 12007   # history too short
    assert out[2] == 18007                      # +1 slip corrected
    assert out[3] == 24007
    assert out[4] == 30007                      # -1 slip corrected
    assert out[5] == 36007


def test_cn0_estimate_matches_planted(short_capture):
    """M2M4 C/N0 estimate near the planted 49 dBHz.  The compressed-time
    4-satellite scenario biases a few dB low (cross-correlation
    interference between four strong signals + residual bit-edge
    attenuation); single-satellite calibration is <1 dB (see
    receiver._m2m4_cn0 docstring)."""
    x, _ = short_capture
    rx = Receiver(_cfg())
    rx.run(x)
    for ch in rx.channels:
        assert 43.0 < ch.cn0_dbhz < 52.0, (ch.prn, ch.cn0_dbhz)


def test_acq_timeout_widens_search():
    """AcqConfig.timeout_ms (acquisition.c:13, :217-224 semantics): a
    standby channel whose confined (hinted) search keeps failing
    discards the stale hint after the timeout and re-enters a full-grid
    search, which then succeeds."""
    from stm32f4_sdr_gps_tpu.config import AcqConfig

    x, _ = _make_capture(700, seed=13)
    # PRN 24 really sits at -400 Hz; the configured hint is wrong by
    # almost 4 kHz, so the confined search can never find it
    cfg = _cfg(doppler_hints_hz=(None, None, None, 3500.0),
               acq=AcqConfig(timeout_ms=400))
    rx = Receiver(cfg)
    rx.acquire_all(x)
    assert not rx.channels[3].acq.detected
    rx.start_tracking(x)
    assert [ch.prn for ch in rx.standby_channels] == [24]
    sb = rx.standby_channels[0]

    win = x[: 500 * 2046]
    rx.epoch_cursor = 500
    assert rx.maybe_reacquire(win) == []       # hint confines -> fail
    assert sb.acq_search_start_ms == 500
    assert sb.acq_timeouts == 0

    rx.epoch_cursor = 980                      # > timeout_ms later
    added = rx.maybe_reacquire(win)
    assert sb.acq_timeouts == 1                # search state was reset
    assert added == [24]                       # full-grid search found it
    assert sb.state_name == "TRACKING"
    assert abs(rx.channels[-1].acq.doppler_hz - (-400.0)) < 300.0


def test_msm_lock_time_nontrivial():
    """DF402 lock-time indicator must reflect continuous tracking time,
    not stay at 0 (< 32 ms) forever."""
    x, _ = _make_capture(4400, seed=13)
    rx = Receiver(_cfg(enable_rtcm=True))
    rx.run(x)
    msm_locks = []
    for f in rx.rtcm_frames:
        payload = deframe(f)
        msg = (payload[0] << 4) | (payload[1] >> 4)
        if msg == 1075:
            d = decode_msm(payload)
            msm_locks.append([o["lock"] for o in d["obs"]])
    assert msm_locks, "no MSM frames"
    # by the last emission every channel has been locked for seconds
    assert min(msm_locks[-1]) >= 7      # DF402 >= 7 <=> >= 2.048 s
    # lock time grows monotonically while lock holds
    firsts = [locks[0] for locks in msm_locks]
    assert firsts == sorted(firsts)


def test_half_cycle_resolution_and_phaserange_motion():
    """Once nav polarity is pinned the Costas half-cycle ambiguity is
    resolved (DF420 clears) and the MSM phaserange is carrier-
    continuous: it moves WITH the pseudorange between emissions (a
    frozen or sign-flipped phaserange both fail the consistency
    bound).  The firmware never forms a carrier observable
    (rtklib_common.c:84 leaves obsd L=0) — framework-only capability."""
    x, _ = _make_capture(4400, seed=13)
    rx = Receiver(_cfg(enable_rtcm=True))
    rx.run(x)

    for ch in rx.channels:
        assert ch.half_cycle_known and ch.half_cycle in (-1, 1), ch.prn

    frames = []
    for f in rx.rtcm_frames:
        payload = deframe(f)
        if (payload[0] << 4) | (payload[1] >> 4) == 1075:
            frames.append(decode_msm(payload))
    assert len(frames) >= 2, "need successive MSM emissions"
    assert all(not o["half_cycle_ambiguous"] for o in frames[-1]["obs"])

    prev = {o["sat"]: o for o in frames[-2]["obs"]}
    last = {o["sat"]: o for o in frames[-1]["obs"]}
    moved = 0
    for sat, o1 in last.items():
        o0 = prev.get(sat)
        if not o0 or not o0["phaserange_m"] or not o1["phaserange_m"]:
            continue
        d_ph = o1["phaserange_m"] - o0["phaserange_m"]
        d_pr = o1["pseudorange_m"] - o0["pseudorange_m"]
        # carrier delta tracks the (Hatch-smoothed) code delta.  Bound:
        # DLL discriminator bias wanders a few m/s (half-chip lag
        # spacing at 2 samples/chip), so allow 20 m; the failure modes
        # this guards against — frozen phaserange, sign-flipped
        # carrier, or drift at the reference range rate — all produce
        # >=80 m here (deltas are 100-200 m between emissions).
        assert abs(d_ph - d_pr) < 20.0, (sat, d_ph, d_pr)
        if abs(d_ph) > 0.01:
            moved += 1
    assert moved, "phaserange frozen across emissions"


def _receiver_with_consistent_channels(fault_ch=None, fault_ms=0):
    """Receiver whose channels carry a synthetic but physically
    consistent observables ledger (subframe boundary + code phase
    reconstruct exactly the forward-model pseudoranges of
    tests.test_pvt), so _try_solve exercises the real formation +
    solver + plausibility chain without a 30 s capture."""
    from stm32f4_sdr_gps_tpu.config import CLIGHT, GPS_OFFSET_TIME_MS
    from stm32f4_sdr_gps_tpu.pvt.gpstime import time2gpst
    from stm32f4_sdr_gps_tpu.runtime.receiver import ChannelStatus
    from tests.test_pvt import _four_sat_obs

    rr_true, obs_time, eph_map, obs = _four_sat_obs(with_doppler=True)
    c_ms = CLIGHT / 1000.0
    meas_ms = 50_000
    p_ref = min(o.P for o in obs)
    a_ref = meas_ms - 100.0
    tow_obs, week = time2gpst(obs_time)
    tow0 = tow_obs - (meas_ms - a_ref) / 1000.0

    rx = Receiver(_cfg(enable_position=True, enable_code_filter=False))
    channels = []
    for o in obs:
        arrival = a_ref + (o.P - p_ref) / c_ms
        frac = arrival % 1.0
        ch = ChannelStatus(prn=o.sat)
        ch.eph = eph_map[o.sat]
        ch.eph.week = week
        ch.subframe_time_ms = int(round(arrival))
        ch.code_phase_chips = (1023.0 * (1.0 - frac)) % 1023.0
        ch.subframe_tow_s = tow0
        ch.doppler_hz = o.D
        ch.snr_db = 10.0
        channels.append(ch)
    if fault_ch is not None:
        channels[fault_ch].subframe_time_ms += fault_ms
    rx.channels = channels
    return rx, rr_true, meas_ms


def test_try_solve_corrects_grid_fault():
    """End-to-end _try_solve: a 3 ms boundary-ledger fault on one
    channel at exactly 4 satellites is identified, the fix corrected,
    and the channel's ledger bias remembered for future solves."""
    rx, rr_true, meas_ms = _receiver_with_consistent_channels()
    rx._try_solve(meas_ms, None)
    # ~2 m inherent: the relative-pseudorange convention's common
    # offset shifts the assumed transmit times by ~1.5 ms
    assert rx.solutions and np.linalg.norm(
        rx.solutions[-1].rr - rr_true) < 5.0

    rx, rr_true, meas_ms = _receiver_with_consistent_channels(
        fault_ch=2, fault_ms=3)
    rx._try_solve(meas_ms, None)
    assert rx.solutions, "faulted epoch was rejected instead of corrected"
    assert np.linalg.norm(rx.solutions[-1].rr - rr_true) < 5.0
    ch = rx.channels[2]
    assert ch.grid_bias_ms == -3 and ch.grid_faults == 1
    # next solve reuses the remembered bias without a new search
    # (same epoch: the synthetic channels are frozen in time)
    rx._try_solve(meas_ms, None)
    assert len(rx.solutions) == 2
    assert np.linalg.norm(rx.solutions[-1].rr - rr_true) < 5.0
    assert ch.grid_faults == 1


def test_try_solve_rejects_without_search():
    rx, rr_true, meas_ms = _receiver_with_consistent_channels(
        fault_ch=1, fault_ms=-2)
    rx.config = rx.config.replace(grid_fault_search=False)
    rx._try_solve(meas_ms, None)
    assert not rx.solutions, "implausible fix must be rejected"


def test_profiler_stages_populated(short_capture):
    """The per-stage profiler (utils.profiling, the DWT-timer role) is
    wired into the receiver pipeline and surfaces via render_status."""
    from stm32f4_sdr_gps_tpu.io.status import render_status

    x, _ = short_capture
    rx = Receiver(_cfg())
    rx.run(x)
    stages = rx.profiler.stages
    for name in ("acquire", "pretrack", "track", "decode"):
        assert name in stages and stages[name].calls > 0, name
    assert stages["track"].budget_s is not None   # real-time budget alarm
    report = render_status(rx, profile=True)
    assert "track" in report and "mean ms" in report


def test_hatch_update_idempotent_per_epoch():
    """VERDICT r2 weak-5: the Hatch filter is read by both the solve
    (500 ms) and RTCM (200 ms) cadences; at their coincident epochs
    (every 1000 ms) the same code measurement must fold ONCE, not
    twice — double-folding shortens the filter window and biases the
    smoothed P toward that epoch's raw code noise."""
    from stm32f4_sdr_gps_tpu.pvt.observables import HatchState

    rng = np.random.default_rng(7)
    h = HatchState(window=100)
    # distinct epochs each fold one measurement
    p1 = h.update(20000.0e3 + rng.normal() * 3.0, 0.0, epoch_ms=200)
    assert h.count == 1
    p2 = h.update(20000.0e3 + rng.normal() * 3.0, -100.0, epoch_ms=400)
    assert h.count == 2
    # a second consumer at the SAME epoch: no fold, same output
    p2b = h.update(20000.0e3 + 50.0, -100.0, epoch_ms=400)
    assert h.count == 2
    assert p2b == p2
    # and the next distinct epoch folds normally
    h.update(20000.0e3 + rng.normal() * 3.0, -200.0, epoch_ms=500)
    assert h.count == 3
    # trajectory equivalence: feeding the same per-epoch series with a
    # duplicated consumer at every epoch matches the single-consumer run
    ha, hb = HatchState(), HatchState()
    out_a, out_b = [], []
    for k in range(50):
        pr = 21000.0e3 - 30.0 * k + rng.normal() * 4.0
        lcyc = k * 30.0 / 0.1902936727983649
        out_a.append(ha.update(pr, lcyc, epoch_ms=k * 200))
        out_b.append(hb.update(pr, lcyc, epoch_ms=k * 200))
        out_b[-1] = hb.update(pr, lcyc, epoch_ms=k * 200)  # 2nd consumer
    assert out_a == out_b


def _demotion_rx(n=3, grace_ms=1000):
    """Receiver with hand-built live tracking state for demotion tests."""
    import jax.numpy as jnp

    from stm32f4_sdr_gps_tpu.runtime.receiver import ChannelStatus
    from stm32f4_sdr_gps_tpu.track.state import init_state

    cfg = _cfg(demote_grace_ms=grace_ms)
    rx = Receiver(cfg)
    rx.channels = [ChannelStatus(prn=p + 1, state_name="TRACKING")
                   for p in range(n)]
    rx.track_state = init_state(
        n, np.zeros(n), np.zeros(n),
        window=cfg.track.pll_check_window)
    rx.code_table = jnp.zeros((n, 16), jnp.float32)
    return rx


def test_demotes_zero_cn0_noise_channel_despite_high_snr():
    """VERDICT r2 weak-6 edge 1: a channel tracking noise whose M2M4
    estimator returns 0.0 must demote even when the I/Q-ratio SNR
    happens to read >= 1 dB (the old gate required snr_db < 1)."""
    rx = _demotion_rx()
    rx.epoch_cursor = 5000
    for ch in rx.channels:
        ch.last_healthy_ms = 4900
        ch.cn0_dbhz = 45.0
    bad = rx.channels[1]
    bad.cn0_dbhz = 0.0          # estimator failed on noise
    bad.snr_db = 3.0            # chance I/Q ratio — old gate never fired
    bad.last_healthy_ms = 2000  # stale for 3 s
    dropped = rx.drop_dead_channels()
    assert dropped == [bad.prn]
    assert [ch.prn for ch in rx.channels] == [1, 3]
    assert rx.track_state.doppler_hz.shape[0] == 2
    assert rx.code_table.shape[0] == 2
    assert bad in rx.standby_channels and bad.state_name == "LOST"


def test_demotes_channel_that_decoded_bits_then_died():
    """VERDICT r2 weak-6 edge 2: a channel that once decoded bits and
    then lost its signal (cn0 -> 0) must not linger forever (the old
    gate's bit_count == 0 clause made it immortal)."""
    rx = _demotion_rx()
    rx.epoch_cursor = 10000
    for ch in rx.channels:
        ch.last_healthy_ms = 9900
        ch.cn0_dbhz = 45.0
    bad = rx.channels[2]
    bad.bit_count = 120         # decoded a whole subframe once
    bad.cn0_dbhz = 0.0
    bad.snr_db = 0.2
    bad.last_healthy_ms = 3000
    assert rx.drop_dead_channels() == [bad.prn]


def test_demotion_respects_grace_window():
    """A short fade (unhealthy for less than the grace window) must NOT
    demote; crossing the window must."""
    rx = _demotion_rx(grace_ms=1500)
    rx.epoch_cursor = 4000
    for ch in rx.channels:
        ch.cn0_dbhz = 20.0              # all below the floor right now
        ch.last_healthy_ms = 3000       # but only stale for 1000 ms
    assert rx.drop_dead_channels() == []
    rx.epoch_cursor = 4600              # stale for 1600 ms > grace
    dropped = rx.drop_dead_channels()
    # never drop the last channel set: all three are dead -> keep none
    # rule says return [] when nothing would remain
    assert dropped == []
    # one healthy channel present -> the stale ones go
    rx.channels[0].cn0_dbhz = 45.0
    rx.channels[0].last_healthy_ms = 4500
    dropped = rx.drop_dead_channels()
    assert sorted(dropped) == [2, 3]
    assert [ch.prn for ch in rx.channels] == [1]
