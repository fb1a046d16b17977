"""Properties of the jnp tracking scan, the receiver's one tracking path.

Block resumption, the false-lock watchdog at any window length, channel
independence (one wide call == many narrow ones), the on-device digest
against a host reduction of the full outputs, channel sharding over the
virtual mesh, and the receiver's digest and full-readback modes giving
the same results.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stm32f4_sdr_gps_tpu.config import BASEBAND_PLAN, ReceiverConfig, TrackConfig
from stm32f4_sdr_gps_tpu.signal.ca_code import ca_table_bipolar
from stm32f4_sdr_gps_tpu.signal.simulator import SimSat, simulate_capture
from stm32f4_sdr_gps_tpu.track.scan import track_block
from stm32f4_sdr_gps_tpu.track.state import init_state

PLAN = BASEBAND_PLAN
PRNS = [1, 4, 7, 9, 13, 18, 22, 30]
CIB = 3  # compressed bit period so bit sync converges within a block
NO_KICK = 10**6  # watchdog counts but never kicks: counters comparable


def _scenario(num_epochs, seed=11):
    rng = np.random.default_rng(seed)
    sats = [SimSat(prn=prn,
                   doppler_hz=float(rng.uniform(-4000, 4000)),
                   code_phase_chips=float(rng.uniform(0, 1023)),
                   cn0_dbhz=48.0, codes_in_bit=CIB,
                   nav_bits=list(rng.integers(0, 2, 200)))
            for prn in PRNS]
    x, _ = simulate_capture(sats, num_epochs=num_epochs, seed=seed)
    epochs = jnp.asarray(x.reshape(num_epochs, PLAN.samples_per_epoch))
    return epochs, sats


def _state(sats, cfg, cp_off=0.1, dop_off=15.0):
    return init_state(
        len(sats),
        np.array([s.code_phase_chips + cp_off for s in sats]),
        np.array([s.doppler_hz + dop_off for s in sats]),
        window=cfg.pll_check_window)


def _assert_trees_equal(a, b):
    for name, x, y in zip(a._fields, a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=name)


MODES = {
    "per-epoch": TrackConfig(codes_in_bit=CIB, pll_bad_state_threshold=NO_KICK),
    "coherent-pll": TrackConfig(codes_in_bit=CIB, coherent_pll=True,
                                pll_bad_state_threshold=NO_KICK),
    "ext-pll": TrackConfig(codes_in_bit=CIB, coherent_pll=True,
                           pll_ext_bits=4, pll_bad_state_threshold=NO_KICK),
}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("split", [40, 44])
def test_split_block_resumes_exactly(mode, split):
    """Two calls split at ``split`` epochs == one 80-epoch call, state
    and outputs (44 leaves both halves off any power of two)."""
    cfg = MODES[mode]
    epochs, sats = _scenario(80, seed=5)
    table = jnp.asarray(ca_table_bipolar(PRNS))
    st0 = _state(sats, cfg, cp_off=0.0, dop_off=0.0)
    st_full, out_full = track_block(st0, epochs, table, PLAN, cfg)
    st_a, out_a = track_block(st0, epochs[:split], table, PLAN, cfg)
    st_b, out_b = track_block(st_a, epochs[split:], table, PLAN, cfg)
    _assert_trees_equal(st_full, st_b)
    for name, full, a, b in zip(out_full._fields, out_full, out_a, out_b):
        np.testing.assert_array_equal(
            np.asarray(full),
            np.concatenate([np.asarray(a), np.asarray(b)]), err_msg=name)
    assert np.asarray(out_full.bit_ready).any(), "no nav bit in 80 epochs"


@pytest.mark.parametrize("window", [3, 6])
def test_watchdog_counters_live_at_any_window(window):
    """With pll_check_window != 4 the sign window has that length, the
    junk channels (300 chips off the signal) trip the false-lock
    counters, and the locked ones stay clean."""
    cfg = TrackConfig(codes_in_bit=CIB, pll_check_window=window,
                      pll_bad_state_threshold=NO_KICK)
    epochs, sats = _scenario(60)
    table = jnp.asarray(ca_table_bipolar(PRNS))
    st0 = _state(sats, cfg)
    junk = np.arange(len(PRNS)) % 2 == 1
    cp0 = np.asarray(st0.code_phase_chips) + np.where(junk, 300.0, 0.0)
    st0 = st0._replace(code_phase_chips=jnp.asarray(cp0, jnp.float32))
    st, outs = track_block(st0, epochs, table, PLAN, cfg)
    assert np.asarray(st.ip_sign_window).shape == (len(PRNS), window)
    bad = np.asarray(st.pll_bad_cnt)
    assert bad[junk].max() > 0, "junk channels never tripped the watchdog"
    assert bad[~junk].max() < bad[junk].max()
    # no kick at an unreachable threshold: the junk Doppler only moves
    # with its loops
    assert np.isfinite(np.asarray(outs.doppler_hz)).all()


def test_wide_call_equals_narrow_calls():
    """256 channels in one call == 8 calls of 32: channels never
    interact inside the scan."""
    n_chan, width = 256, 32
    cfg = TrackConfig(codes_in_bit=CIB)
    epochs, sats = _scenario(12, seed=13)
    rng = np.random.default_rng(13)
    prns = [(i % 32) + 1 for i in range(n_chan)]
    cp = rng.uniform(0, 1023, n_chan)
    dop = rng.uniform(-4000, 4000, n_chan)
    # put the real satellites on some of the wide channels
    for i, s in enumerate(sats):
        prns[31 * i] = s.prn
        cp[31 * i], dop[31 * i] = s.code_phase_chips, s.doppler_hz
    table = ca_table_bipolar(prns)
    st_w, out_w = track_block(init_state(n_chan, cp, dop), epochs,
                              jnp.asarray(table), PLAN, cfg)
    for k in range(n_chan // width):
        sl = slice(k * width, (k + 1) * width)
        st_n, out_n = track_block(init_state(width, cp[sl], dop[sl]), epochs,
                                  jnp.asarray(table[sl]), PLAN, cfg)
        for name, w, n in zip(out_w._fields, out_w, out_n):
            np.testing.assert_array_equal(np.asarray(w)[:, sl],
                                          np.asarray(n), err_msg=name)
        for name, w, n in zip(st_w._fields, st_w, st_n):
            np.testing.assert_array_equal(np.asarray(w)[sl], np.asarray(n),
                                          err_msg=name)


@pytest.mark.parametrize("enable_code_filter", [True, False])
def test_device_digest_equals_host_reduction(enable_code_filter):
    """``_track_and_digest``'s digest == the same statistics reduced on
    the host from the full ``track_block`` outputs."""
    from stm32f4_sdr_gps_tpu.runtime.receiver import _track_and_digest

    cfg = TrackConfig(codes_in_bit=CIB)
    epochs, sats = _scenario(90, seed=19)
    table = jnp.asarray(ca_table_bipolar(PRNS))
    st0 = _state(sats, cfg)
    st, d = _track_and_digest(st0, epochs, table, PLAN, cfg, 40,
                              enable_code_filter)
    st_ref, outs = track_block(st0, epochs, table, PLAN, cfg)
    _assert_trees_equal(st, st_ref)
    d = jax.tree.map(np.asarray, d)
    o = jax.tree.map(np.asarray, outs)
    ready = o.bit_ready
    np.testing.assert_array_equal(d.bit_count, ready.sum(axis=0))
    for c in range(len(PRNS)):
        k = int(d.bit_count[c])
        assert k > 0, "scenario produced no bits"
        np.testing.assert_array_equal(d.bit_value[:k, c],
                                      o.bit_value[ready[:, c], c])
        np.testing.assert_array_equal(d.bit_epoch[:k, c],
                                      o.bit_epoch[ready[:, c], c])
    np.testing.assert_array_equal(d.code_phase_chips, o.code_phase_chips[-1])
    np.testing.assert_array_equal(d.doppler_hz, o.doppler_hz[-1])
    np.testing.assert_allclose(d.doppler_sum, o.doppler_hz.sum(axis=0),
                               rtol=1e-5)
    np.testing.assert_array_equal(d.snr_db, o.snr_db[-1])
    np.testing.assert_array_equal(d.period_sync_ok, o.period_sync_ok[-1])
    np.testing.assert_array_equal(d.first_ip_sign, np.where(o.ip[0] > 0, 1, -1))
    np.testing.assert_array_equal(d.last_ip_sign, np.where(o.ip[-1] > 0, 1, -1))
    if not enable_code_filter:
        np.testing.assert_array_equal(d.code_phase_filtered,
                                      o.code_phase_chips[-1])
    else:
        err = (d.code_phase_filtered - o.code_phase_chips[-1] + 511.5) \
            % 1023.0 - 511.5
        assert np.abs(err).max() < 0.5
    clean = ~(ready | np.concatenate([ready[1:], np.zeros_like(ready[:1])]))
    p = o.ip.astype(np.float64) ** 2 + o.qp.astype(np.float64) ** 2
    np.testing.assert_array_equal(d.cn0_n, clean.sum(axis=0))
    m2 = np.where(clean, p, 0.0).sum(axis=0) / clean.sum(axis=0)
    np.testing.assert_allclose(d.cn0_m2, m2, rtol=1e-4)


@pytest.mark.parametrize("digest", [False, True])
def test_streaming_tracker_equals_unsharded_scan(digest):
    """StreamingTracker over 8 virtual devices == the unsharded scan
    (per-block outputs, or the per-shard digest), state carried over
    two blocks."""
    from stm32f4_sdr_gps_tpu.parallel.mesh import make_mesh
    from stm32f4_sdr_gps_tpu.parallel.streaming import StreamingTracker
    from stm32f4_sdr_gps_tpu.runtime.receiver import _track_and_digest

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    cfg = TrackConfig(codes_in_bit=CIB)
    rcfg = ReceiverConfig(code_filter_len=20)
    epochs, sats = _scenario(60, seed=3)
    table = ca_table_bipolar(PRNS)
    st0 = _state(sats, cfg)
    mesh = make_mesh(time=2, chan=4)
    tracker = StreamingTracker(st0, table, mesh, PLAN, cfg)
    x = np.asarray(epochs).reshape(-1)
    spe = PLAN.samples_per_epoch
    st = st0
    for b in range(2):
        block = x[b * 30 * spe:(b + 1) * 30 * spe]
        if digest:
            got = tracker.process_digest(block, rcfg)
            st, want = _track_and_digest(
                st, epochs[b * 30:(b + 1) * 30], jnp.asarray(table), PLAN,
                cfg, rcfg.code_filter_len, rcfg.enable_code_filter)
        else:
            got = tracker.process(block)
            st, want = track_block(st, epochs[b * 30:(b + 1) * 30],
                                   jnp.asarray(table), PLAN, cfg)
        for name, g, w in zip(want._fields, got, want):
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       rtol=1e-5, atol=1e-3, err_msg=name)
    np.testing.assert_allclose(np.asarray(tracker.state.code_phase_chips),
                               np.asarray(st.code_phase_chips), atol=1e-4)


def test_receiver_digest_on_and_off_agree():
    """The Receiver decodes the same bits, subframes and channel state
    with the device digest (default) and with full (T, C) readback."""
    from stm32f4_sdr_gps_tpu.runtime.receiver import Receiver

    from tests.test_receiver import CIB as RX_CIB
    from tests.test_receiver import PRNS as RX_PRNS
    from tests.test_receiver import _make_capture

    x, _ = _make_capture(120 * RX_CIB + 2 * 300 * RX_CIB + 200, seed=7)
    base = ReceiverConfig(
        prns=RX_PRNS,
        track=TrackConfig(codes_in_bit=RX_CIB,
                          pll_bad_state_threshold=10**9),
        enable_position=False, track_block_epochs=250)
    reports = []
    for on in (True, False):
        rx = Receiver(dataclasses.replace(base, device_digest=on))
        assert rx._digest_active == on
        reports.append(rx.run(x))
    on, off = reports
    assert [c.prn for c in on.channels] == [c.prn for c in off.channels]
    for a, b in zip(on.channels, off.channels):
        assert a.bit_count == b.bit_count and a.bit_count > 100, a.prn
        assert a.subframe_count == b.subframe_count >= 1, a.prn
        assert a.subframe_time_ms == b.subframe_time_ms, a.prn
        assert a.bit_synced == b.bit_synced
        assert abs(a.doppler_hz - b.doppler_hz) < 1e-3
        assert abs(a.code_phase_chips - b.code_phase_chips) < 1e-3


def test_checkpoint_keeps_raw_code_table(tmp_path):
    """A checkpoint round trip restores the raw (C, 1023) bipolar table
    the scan reads."""
    from stm32f4_sdr_gps_tpu.runtime.checkpoint import (
        load_receiver,
        save_receiver,
    )
    from stm32f4_sdr_gps_tpu.runtime.receiver import Receiver

    from tests.test_receiver import PRNS as RX_PRNS
    from tests.test_receiver import _make_capture

    x, _ = _make_capture(300, seed=4)
    rx = Receiver(ReceiverConfig(prns=RX_PRNS))
    rx.acquire_all(x)
    rx.start_tracking(x)
    n = len(rx.channels)
    assert rx.code_table.shape == (n, 1023)
    rx2 = load_receiver(save_receiver(str(tmp_path / "ck"), rx))
    assert rx2.code_table.shape == (n, 1023)
    np.testing.assert_array_equal(np.asarray(rx2.code_table),
                                  np.asarray(rx.code_table))
    np.testing.assert_array_equal(
        np.asarray(rx2.code_table),
        ca_table_bipolar([c.prn for c in rx.channels]))
