"""Acquisition engine tests against simulator ground truth.

Mirrors BASELINE.json config 1 (single-satellite +/-5 kHz grid on a
2.046 MHz IQ capture, CPU-runnable) and the multi-PRN cold start.
"""

import numpy as np
import pytest

from stm32f4_sdr_gps_tpu.config import AcqConfig, BASEBAND_PLAN
from stm32f4_sdr_gps_tpu.acquire.engine import acquire, acquire_epoch_vote
from stm32f4_sdr_gps_tpu.signal.simulator import SimSat, simulate_capture


def _phase_err(a, b):
    return (a - b + 511.5) % 1023.0 - 511.5


def test_single_sat_acquisition():
    sat = SimSat(prn=7, doppler_hz=3210.0, code_phase_chips=123.4,
                 cn0_dbhz=45.0)
    x, _ = simulate_capture([sat], num_epochs=10, seed=3)
    cfg = AcqConfig(doppler_span_hz=5000.0)
    res = acquire(x, [7], BASEBAND_PLAN, cfg)[0]
    assert res.detected
    assert abs(res.doppler_hz - 3210.0) < 250.0
    assert abs(_phase_err(res.code_phase_chips, 123.4)) < 0.5


def test_absent_prn_not_detected():
    sat = SimSat(prn=7, doppler_hz=1000.0, cn0_dbhz=45.0)
    x, _ = simulate_capture([sat], num_epochs=10, seed=4)
    res = acquire(x, [13], BASEBAND_PLAN, AcqConfig())[0]
    assert not res.detected


def test_multi_sat_cold_start():
    sats = [
        SimSat(prn=2, doppler_hz=-4200.0, code_phase_chips=1000.9,
               cn0_dbhz=44.0),
        SimSat(prn=5, doppler_hz=250.0, code_phase_chips=17.0,
               cn0_dbhz=47.0),
        SimSat(prn=23, doppler_hz=6500.0, code_phase_chips=512.0,
               cn0_dbhz=43.0),
    ]
    x, _ = simulate_capture(sats, num_epochs=10, seed=5)
    results = acquire(x, [2, 5, 23, 30], BASEBAND_PLAN, AcqConfig())
    by_prn = {r.prn: r for r in results}
    for sat in sats:
        r = by_prn[sat.prn]
        assert r.detected, sat.prn
        assert abs(r.doppler_hz - sat.doppler_hz) < 250.0
        assert abs(_phase_err(r.code_phase_chips, sat.code_phase_chips)) < 0.5
    assert not by_prn[30].detected


def test_weak_signal_needs_integration():
    """38 dBHz: 1 epoch is marginal, 10 non-coherent epochs must detect."""
    sat = SimSat(prn=11, doppler_hz=-1500.0, code_phase_chips=700.0,
                 cn0_dbhz=38.0)
    x, _ = simulate_capture([sat], num_epochs=10, seed=6)
    res10 = acquire(x, [11], BASEBAND_PLAN, AcqConfig(noncoherent_epochs=10))[0]
    assert res10.detected
    assert abs(_phase_err(res10.code_phase_chips, 700.0)) < 0.75


def test_epoch_vote_mode_matches():
    """Firmware-compatible histogram-vote detector finds the same answer."""
    sat = SimSat(prn=4, doppler_hz=2500.0, code_phase_chips=345.0,
                 cn0_dbhz=46.0)
    x, _ = simulate_capture([sat], num_epochs=10, seed=7)
    res = acquire_epoch_vote(x, [4], BASEBAND_PLAN, AcqConfig())[0]
    assert res.detected
    assert res.doppler_hz == pytest.approx(2500.0, abs=250.0)
    assert abs(_phase_err(res.code_phase_chips, 345.0)) < 1.0


def test_nav_bit_transition_tolerance():
    """Non-coherent integration must survive bit flips mid-capture."""
    bits = np.array([0, 1] * 13, dtype=np.int8)
    sat = SimSat(prn=8, doppler_hz=500.0, code_phase_chips=50.0,
                 cn0_dbhz=44.0, nav_bits=bits, nav_epoch_offset=10)
    x, _ = simulate_capture([sat], num_epochs=10, seed=8)
    res = acquire(x, [8], BASEBAND_PLAN, AcqConfig())[0]
    assert res.detected
    assert abs(_phase_err(res.code_phase_chips, 50.0)) < 0.5


def test_refine_doppler_sub_hz():
    """Long coherent FFT refinement: coarse-grid error (tens of Hz)
    collapses to a few Hz, robust to nav-bit flips (squaring)."""
    from stm32f4_sdr_gps_tpu.acquire.engine import refine_doppler

    bits = np.random.default_rng(1).integers(0, 2, 20).astype(np.int8)
    sat = SimSat(prn=19, doppler_hz=-2711.0, code_phase_chips=512.0,
                 cn0_dbhz=44.0, nav_bits=bits)
    x, _ = simulate_capture([sat], num_epochs=40, seed=9)
    r = acquire(x, [19], BASEBAND_PLAN, AcqConfig())[0]
    assert r.detected
    fine = refine_doppler(x, 19, r.code_phase_chips, r.doppler_hz)
    assert abs(fine + 2711.0) < 5.0
    assert abs(fine + 2711.0) <= abs(r.doppler_hz + 2711.0) + 1e-6


def test_matmul_dft_matches_fft_cube():
    """ops.correlate.matmul_circular_correlate == the FFT path.

    The matmul-DFT formulation runs the transform as dense products
    (S=2046 has no power-of-two FFT); the acquisition cube it produces
    must match the FFT cube
    to float32 round-off so every detector/threshold downstream is
    path-independent."""
    import jax.numpy as jnp
    from stm32f4_sdr_gps_tpu.acquire.engine import acquisition_power
    from stm32f4_sdr_gps_tpu.ops.correlate import code_fft_conj, dft_tables
    from stm32f4_sdr_gps_tpu.ops.wipeoff import doppler_rotations

    sat = SimSat(prn=9, doppler_hz=-1750.0, code_phase_chips=400.25,
                 cn0_dbhz=45.0)
    x, _ = simulate_capture([sat], num_epochs=4, seed=11)
    s = BASEBAND_PLAN.samples_per_epoch
    epochs = jnp.asarray(x[: 4 * s].reshape(4, s), dtype=jnp.complex64)
    cfc = code_fft_conj([9, 17], BASEBAND_PLAN)
    rot = doppler_rotations(jnp.asarray([-2000.0, -1500.0, 0.0]), s,
                            BASEBAND_PLAN.sample_rate_hz)
    wc, ws = dft_tables(s)
    p_fft = np.asarray(acquisition_power(epochs, cfc, rot))
    p_mm = np.asarray(acquisition_power(
        epochs, cfc, rot, dft=(jnp.asarray(wc), jnp.asarray(ws))))
    scale = float(p_fft.max())
    np.testing.assert_allclose(p_mm / scale, p_fft / scale, atol=5e-4)


def test_acquire_with_matmul_dft():
    """acquire() end-to-end on the matmul-DFT path."""
    sat = SimSat(prn=21, doppler_hz=2400.0, code_phase_chips=77.7,
                 cn0_dbhz=45.0)
    x, _ = simulate_capture([sat], num_epochs=10, seed=12)
    cfg = AcqConfig(doppler_span_hz=5000.0, use_matmul_dft=True)
    res = acquire(x, [21], BASEBAND_PLAN, cfg)[0]
    assert res.detected
    assert abs(res.doppler_hz - 2400.0) < 250.0
    assert abs(_phase_err(res.code_phase_chips, 77.7)) < 0.5


def test_bf16_dft_precision_detection_equivalence(monkeypatch):
    """AcqConfig.dft_precision="default" lets the GPU round the DFT
    matmul inputs (TF32 on an H100: 10-bit mantissa, f32 accumulation).
    The CPU backend is f32 either way, so this test EMULATES a coarser
    rounding — bfloat16 inputs (7-bit mantissa), f32 accumulation,
    which bounds TF32's — and pins that detection
    decisions, peak statistics and sub-sample interpolation agree with
    f32 to ~1e-3 at both strong and threshold C/N0 (the noncoherent
    integration averages the per-product rounding)."""
    import jax
    import jax.numpy as jnp
    from stm32f4_sdr_gps_tpu.acquire import engine as eng
    from stm32f4_sdr_gps_tpu.config import DEEP_ACQ
    from stm32f4_sdr_gps_tpu.ops import correlate as corr
    from stm32f4_sdr_gps_tpu.ops.wipeoff import doppler_rotations

    class Bf16EmulatedJnp:
        def __getattr__(self, k):
            return getattr(jnp, k)

        @staticmethod
        def matmul(a, b, precision=None):
            return jnp.matmul(a.astype(jnp.bfloat16),
                              b.astype(jnp.bfloat16),
                              preferred_element_type=jnp.float32)

    plan = BASEBAND_PLAN
    s = plan.samples_per_epoch
    table = corr.unpack_code_table(
        jnp.asarray(corr.pack_code_bits([9], plan)), s)
    wc, ws = corr.dft_tables_device(s)
    cfc = corr.code_spectrum_conj_matmul(table, wc, ws)

    for cn0, acq in ((45.0, AcqConfig()), (31.0, DEEP_ACQ)):
        sat = SimSat(prn=9, doppler_hz=1830.0, code_phase_chips=411.25,
                     cn0_dbhz=cn0, codes_in_bit=20, nav_bits=[0, 1] * 40)
        e = max(acq.noncoherent_epochs, 10)
        co = acq.coherent_epochs
        x, _ = simulate_capture([sat], num_epochs=e, seed=3)
        epochs = jnp.asarray(x.reshape(e, s))
        bins = np.asarray(acq.doppler_bins_hz, np.float32)
        rot = doppler_rotations(jnp.asarray(bins), s, plan.sample_rate_hz)
        res = {}
        for name in ("f32", "bf16"):
            monkeypatch.setattr(
                corr, "jnp", Bf16EmulatedJnp() if name == "bf16" else jnp)
            eng.acquisition_power.clear_cache()
            p = eng.acquisition_power(epochs[: (e // co) * co], cfc, rot,
                                      coherent=co, dft=(wc, ws))
            res[name] = eng.analyze_power(p, [9], bins, plan, acq)[0]
        eng.acquisition_power.clear_cache()
        a, b = res["f32"], res["bf16"]
        assert a.detected and b.detected, cn0
        assert abs(a.doppler_hz - b.doppler_hz) < 2.0, cn0
        assert abs(_phase_err(a.code_phase_chips, b.code_phase_chips)) \
            < 0.01, cn0
        assert abs(a.peak_ratio - b.peak_ratio) < 0.02 * a.peak_ratio, cn0
        assert abs(a.peak_to_mean - b.peak_to_mean) \
            < 0.02 * a.peak_to_mean, cn0


def test_packed_code_bits_roundtrip_and_matmul_spectrum():
    """8 KB bit-packed upload rebuilds the exact code table on device,
    and the matmul-built conj spectrum matches the FFT one (the no-FFT
    no-big-upload acquisition build for restrictive transports)."""
    import jax.numpy as jnp
    from stm32f4_sdr_gps_tpu.ops.correlate import (
        code_spectrum_conj_matmul, dft_tables_device, pack_code_bits,
        sampled_code_table, unpack_code_table)

    prns = [3, 9, 27]
    s = BASEBAND_PLAN.samples_per_epoch
    packed = pack_code_bits(prns, BASEBAND_PLAN)
    assert packed.nbytes < 1024 * len(prns)
    table = np.asarray(unpack_code_table(jnp.asarray(packed), s))
    np.testing.assert_array_equal(table,
                                  sampled_code_table(prns, BASEBAND_PLAN))
    wc, ws = dft_tables_device(s)
    cfc_mm = np.asarray(code_spectrum_conj_matmul(jnp.asarray(table), wc, ws))
    cfc_fft = np.conj(np.fft.fft(table, axis=-1))
    np.testing.assert_allclose(cfc_mm, cfc_fft, atol=2e-2 * np.abs(
        cfc_fft).max())


def test_analyze_power_device_edge_cases():
    """Device analyzer vs an independent numpy reimplementation on
    adversarial cubes: peak at Doppler-bin edges (no interior parabolic
    fit), peak at lag 0 (wraparound neighbors + wraparound exclusion
    zone), and a single-bin cube (hint-confined search, step=0)."""
    import jax.numpy as jnp
    from stm32f4_sdr_gps_tpu.acquire.engine import analyze_power_device

    rng = np.random.default_rng(42)
    s = 64
    excl = 5

    def host_ref(power, bins):
        p_cnt, d_cnt, _ = power.shape
        out = []
        for pi in range(p_cnt):
            cube = power[pi]
            di, si = divmod(int(np.argmax(cube)), s)
            peak = cube[di, si]
            row = cube[di]
            den = row[(si - 1) % s] - 2 * peak + row[(si + 1) % s]
            frac = 0.5 * (row[(si - 1) % s] - row[(si + 1) % s]) / den \
                if abs(den) > 1e-12 else 0.0
            lag = si + np.clip(frac, -0.5, 0.5)
            if 0 < di < d_cnt - 1:
                dden = cube[di - 1, si] - 2 * peak + cube[di + 1, si]
                dfrac = np.clip(0.5 * (cube[di - 1, si] - cube[di + 1, si])
                                / dden, -0.5, 0.5) if abs(dden) > 1e-12 else 0
            else:
                dfrac = 0.0
            step = bins[1] - bins[0] if d_cnt > 1 else 0.0
            dopp = bins[di] + dfrac * step
            idx = np.arange(s)
            dist = np.minimum((idx - si) % s, (si - idx) % s)
            second = np.where(dist[None, :] > excl, cube, 0.0).max()
            out.append((peak, lag, dopp, second, cube.mean()))
        return np.array(out, dtype=np.float32)

    # multi-bin cube with peaks forced onto edges/wraparound positions
    bins = np.array([-1000.0, 0.0, 1000.0], dtype=np.float32)
    power = rng.random((4, 3, s)).astype(np.float32)
    power[0, 0, 0] = 10.0      # lowest bin edge + lag 0 (wraparound)
    power[1, 2, s - 1] = 9.0   # highest bin edge + last lag
    power[2, 1, 17] = 8.0      # interior: real parabolic fits both axes
    power[3, 1, 17] = 8.0
    power[3, 1, (17 + excl + 3) % s] = 7.5   # strong second peak
    got = analyze_power_device(jnp.asarray(power), jnp.asarray(bins), excl)
    want = host_ref(power, bins)
    np.testing.assert_allclose(
        np.stack([np.asarray(v) for v in got], axis=1), want,
        rtol=1e-5, atol=1e-5)

    # single-Doppler-bin cube (hint-confined): step must be 0, not NaN
    power1 = rng.random((2, 1, s)).astype(np.float32)
    got1 = analyze_power_device(jnp.asarray(power1),
                                jnp.asarray(bins[:1]), excl)
    want1 = host_ref(power1, bins[:1])
    np.testing.assert_allclose(
        np.stack([np.asarray(v) for v in got1], axis=1), want1,
        rtol=1e-5, atol=1e-5)
