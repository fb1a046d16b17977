"""Mesh-sharded acquisition/tracking tests on the 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stm32f4_sdr_gps_tpu.config import AcqConfig, BASEBAND_PLAN, TrackConfig
from stm32f4_sdr_gps_tpu.acquire.engine import acquisition_power, analyze_power
from stm32f4_sdr_gps_tpu.ops.correlate import code_fft_conj
from stm32f4_sdr_gps_tpu.ops.wipeoff import doppler_rotations
from stm32f4_sdr_gps_tpu.parallel.mesh import (
    halo_extend_blocks,
    make_mesh,
    replicated,
    shard_code_table,
    shard_track_state,
    sharded_acquisition_power,
)
from stm32f4_sdr_gps_tpu.signal.ca_code import ca_table_bipolar
from stm32f4_sdr_gps_tpu.signal.simulator import SimSat, simulate_capture
from stm32f4_sdr_gps_tpu.track.scan import track_block
from stm32f4_sdr_gps_tpu.track.state import init_state

PLAN = BASEBAND_PLAN


def _need_devices(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual devices")


def test_sharded_acquisition_matches_single_device():
    _need_devices(8)
    mesh = make_mesh(time=2, chan=4)
    prns = list(range(1, 9))          # 8 PRNs over 4 chan shards
    sat = SimSat(prn=3, doppler_hz=1500.0, code_phase_chips=222.0,
                 cn0_dbhz=46.0)
    x, _ = simulate_capture([sat], num_epochs=4, seed=1)
    epochs = jnp.asarray(
        x.reshape(4, PLAN.samples_per_epoch), jnp.complex64
    )
    cfc = code_fft_conj(prns, PLAN)
    bins = np.arange(-2000.0, 2001.0, 500.0, dtype=np.float32)
    rot = doppler_rotations(jnp.asarray(bins), PLAN.samples_per_epoch,
                            PLAN.sample_rate_hz)

    ref = acquisition_power(epochs, cfc, rot)
    with jax.sharding.set_mesh(mesh):
        got = sharded_acquisition_power(epochs, cfc, rot, mesh)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-4, atol=1e-2)
    # and the detector still finds the satellite
    res = analyze_power(np.asarray(got), prns, bins, PLAN,
                        AcqConfig())
    by = {r.prn: r for r in res}
    assert by[3].detected and abs(by[3].doppler_hz - 1500.0) < 250.0


def test_sharded_tracking_matches_single_device():
    _need_devices(8)
    mesh = make_mesh(time=2, chan=4)
    sats = [
        SimSat(prn=p, doppler_hz=100.0 * p, code_phase_chips=10.0 * p,
               cn0_dbhz=46.0)
        for p in range(1, 9)
    ]
    E = 40
    x, _ = simulate_capture(sats, num_epochs=E, seed=2)
    epochs = jnp.asarray(x.reshape(E, PLAN.samples_per_epoch))
    table = jnp.asarray(ca_table_bipolar([s.prn for s in sats]))
    cfg = TrackConfig()
    st0 = init_state(
        8,
        np.array([s.code_phase_chips for s in sats]),
        np.array([s.doppler_hz for s in sats]),
    )
    ref_state, ref_outs = track_block(st0, epochs, table, PLAN, cfg)

    st_sharded = shard_track_state(st0, mesh)
    table_s = shard_code_table(table, mesh)
    epochs_s = replicated(epochs, mesh)
    with jax.sharding.set_mesh(mesh):
        got_state, got_outs = track_block(
            st_sharded, epochs_s, table_s, PLAN, cfg
        )
    np.testing.assert_allclose(
        np.asarray(got_state.code_phase_chips),
        np.asarray(ref_state.code_phase_chips), atol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(got_outs.ip), np.asarray(ref_outs.ip),
        rtol=1e-3, atol=0.5
    )


def test_halo_extend_blocks():
    _need_devices(8)
    mesh = make_mesh(time=2, chan=4)
    blocks = jnp.arange(6 * 10, dtype=jnp.float32).reshape(6, 10)
    with jax.sharding.set_mesh(mesh):
        ext = halo_extend_blocks(blocks, 3, mesh)
    ext = np.asarray(ext)
    assert ext.shape == (6, 13)
    for i in range(5):
        np.testing.assert_array_equal(ext[i, 10:], np.asarray(blocks)[i + 1, :3])
    np.testing.assert_array_equal(ext[5, 10:], np.zeros(3))


def test_dryrun_multichip_entrypoints():
    """The driver contract: __graft_entry__ must compile and run."""
    import __graft_entry__ as ge

    fn, args = ge.entry()
    ts, digest = fn(*args)
    # the Receiver's per-block program: TrackState + on-device
    # BlockDigest over 32 channels
    assert np.asarray(digest.bit_count).shape == (32,)
    assert np.asarray(ts.code_phase_chips).shape == (32,)
    assert np.asarray(ts.epoch_idx).tolist() == [100] * 32
    ge.dryrun_multichip(min(8, len(jax.devices())))


def test_acquire_sharded_applies_doppler_hints():
    """Doppler hints must confine the sharded search the same way the
    single-device acquire() does (MeshReceiver passes them through)."""
    from stm32f4_sdr_gps_tpu.parallel.streaming import acquire_sharded

    _need_devices(8)
    mesh = make_mesh(time=2, chan=4)
    sat = SimSat(prn=3, doppler_hz=1500.0, code_phase_chips=222.0,
                 cn0_dbhz=46.0)
    x, _ = simulate_capture([sat], num_epochs=10, seed=1)
    prns = list(range(1, 9))
    cfg = AcqConfig(noncoherent_epochs=10)

    # correct hint: detection confined to the right bin
    res = acquire_sharded(x, prns, mesh, PLAN, cfg,
                          doppler_hints_hz={3: 1500.0})
    by = {r.prn: r for r in res}
    assert by[3].detected and abs(by[3].doppler_hz - 1500.0) < 250.0

    # wrong hint: the confined search cannot see the satellite
    res = acquire_sharded(x, prns, mesh, PLAN, cfg,
                          doppler_hints_hz={3: -4000.0})
    by = {r.prn: r for r in res}
    assert not by[3].detected


def test_acquire_sharded_matmul_dft():
    """Mesh-sharded acquisition on the matmul-DFT path finds the
    planted satellite with the same verdicts as the FFT path."""
    from stm32f4_sdr_gps_tpu.parallel.streaming import acquire_sharded

    _need_devices(8)
    mesh = make_mesh(time=2, chan=4)
    sat = SimSat(prn=5, doppler_hz=-2250.0, code_phase_chips=901.5,
                 cn0_dbhz=46.0)
    x, _ = simulate_capture([sat], num_epochs=10, seed=2)
    prns = list(range(1, 9))
    res_mm = acquire_sharded(x, prns, mesh, PLAN,
                             AcqConfig(use_matmul_dft=True))
    res_ff = acquire_sharded(x, prns, mesh, PLAN, AcqConfig())
    for mm, ff in zip(res_mm, res_ff):
        assert mm.detected == ff.detected
        if mm.detected:
            assert abs(mm.doppler_hz - ff.doppler_hz) < 5.0
            assert abs(mm.code_phase_chips - ff.code_phase_chips) < 0.05
    by = {r.prn: r for r in res_mm}
    assert by[5].detected and abs(by[5].doppler_hz + 2250.0) < 250.0
