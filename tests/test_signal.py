"""Simulator + capture ingest tests."""

import numpy as np

from stm32f4_sdr_gps_tpu.config import (
    BASEBAND_PLAN,
    REFERENCE_PLAN,
    CODE_LENGTH,
)
from stm32f4_sdr_gps_tpu.signal.capture import (
    pack_bits_lsb16,
    reference_to_baseband,
    unpack_bits_lsb16,
)
from stm32f4_sdr_gps_tpu.signal.simulator import SimSat, simulate_capture


def test_simulator_noiseless_correlation():
    """A noiseless epoch must correlate perfectly against its own replica."""
    sat = SimSat(prn=5, doppler_hz=0.0, code_phase_chips=0.0, cn0_dbhz=60.0)
    x, truth = simulate_capture([sat], num_epochs=1, noise_sigma=1e-12)
    from stm32f4_sdr_gps_tpu.signal.ca_code import ca_code_bits, sample_code

    rep = 1 - 2 * sample_code(ca_code_bits(5), 0.0, 2.0, 2046).astype(np.float64)
    corr = np.abs(np.dot(x, rep))
    # amplitude * N at perfect alignment
    assert corr > 0.9 * truth.amplitudes[0] * 2046


def test_simulator_code_phase_truth():
    sat = SimSat(prn=9, doppler_hz=1500.0, code_phase_chips=321.25)
    _, truth = simulate_capture([sat], num_epochs=2)
    p0 = truth.code_phase_at_epoch(0, 0)
    p1 = truth.code_phase_at_epoch(0, 1)
    assert abs(p0 - 321.25) < 1e-9
    # code Doppler: ~1 ms of extra chips at scaled rate
    drift = (p1 - p0) % CODE_LENGTH
    assert abs(drift - 1.023e6 * (1500.0 / 1.57542e9) * 1e-3) < 1e-6


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(0)
    signs = np.where(rng.standard_normal(16 * 100) > 0, 1.0, -1.0)
    words = pack_bits_lsb16(signs)
    back = unpack_bits_lsb16(words)
    assert np.array_equal(back, signs.astype(np.float32))


def test_reference_format_conditioner_recovers_tone():
    """A 1-bit real capture at IF + doppler must convert to a baseband
    tone at doppler after mix+decimate."""
    fs = REFERENCE_PLAN.sample_rate_hz
    dop = 2000.0
    n = int(fs * 0.005)  # 5 ms
    n -= n % 16
    t = np.arange(n) / fs
    real = np.sign(np.cos(2 * np.pi * (REFERENCE_PLAN.if_freq_hz + dop) * t))
    bb = reference_to_baseband(real)
    assert len(bb) == n // 8
    # Dominant frequency of the baseband signal should be ~dop
    spec = np.abs(np.fft.fft(bb))
    freqs = np.fft.fftfreq(len(bb), d=8 / fs)
    peak_f = freqs[np.argmax(spec)]
    assert abs(peak_f - dop) < 250.0


def test_reference_plan_end_to_end_sim():
    """Simulate in the reference 1-bit plan and check the conditioner
    output correlates at the planted code phase."""
    sat = SimSat(prn=1, doppler_hz=2000.0, code_phase_chips=400.0,
                 cn0_dbhz=50.0)
    x, _ = simulate_capture([sat], num_epochs=4, plan=REFERENCE_PLAN,
                            noise_sigma=1.0, seed=1)
    assert x.dtype == np.float32 and set(np.unique(x)) <= {-1.0, 1.0}
    bb = reference_to_baseband(x)
    from stm32f4_sdr_gps_tpu.acquire.engine import acquire
    from stm32f4_sdr_gps_tpu.config import AcqConfig

    res = acquire(bb, [1], BASEBAND_PLAN,
                  AcqConfig(noncoherent_epochs=4))[0]
    assert res.detected
    assert abs(res.doppler_hz - 2000.0) <= 300.0
    err = (res.code_phase_chips - 400.0 + 511.5) % 1023 - 511.5
    assert abs(err) < 1.0


def test_device_conditioner_matches_host():
    """reference_to_baseband_device (the JAX ingest jit) must agree with
    the host conditioner on the same packed wire words, including when
    the stream is processed in whole-epoch chunks."""
    import jax

    from stm32f4_sdr_gps_tpu.signal.capture import (
        pack_bits_lsb16,
        reference_to_baseband_device,
        unpack_bits_lsb16,
    )

    sat = SimSat(prn=7, doppler_hz=-1500.0, cn0_dbhz=50.0)
    x, _ = simulate_capture([sat], num_epochs=6, plan=REFERENCE_PLAN,
                            noise_sigma=1.0, seed=3)
    words = pack_bits_lsb16(x)
    host = reference_to_baseband(unpack_bits_lsb16(words))

    dev = np.asarray(jax.jit(reference_to_baseband_device)(words))
    assert dev.shape == host.shape
    np.testing.assert_allclose(dev, host, atol=2e-5)

    # chunked at whole epochs (1023 words each): concatenation of chunk
    # outputs equals the one-shot conditioner
    wpe = 1023
    chunks = [
        np.asarray(jax.jit(reference_to_baseband_device)(
            words[i * 3 * wpe:(i + 1) * 3 * wpe]))
        for i in range(2)
    ]
    np.testing.assert_allclose(np.concatenate(chunks), dev, atol=1e-6)
