"""chip_smoke.py and its helpers on the CPU: the compile-cache rule, the
refusal to run without a GPU, the nvidia-smi and result-line formats,
the HLO kernel count, and every phase at a tiny size (compressed 3 ms
nav bits; phase 4 on four of the eight virtual devices)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke as cs
from stm32f4_sdr_gps_tpu.config import (
    BASEBAND_PLAN,
    DEEP_COHERENT_TRACK,
    AcqConfig,
    ReceiverConfig,
    TrackConfig,
)
from stm32f4_sdr_gps_tpu.signal.scenarios import fix_scenario
from stm32f4_sdr_gps_tpu.utils import compile_cache, device_info

REPO = Path(__file__).resolve().parents[1]
CIB = 3


class _RecordingConfig:
    def __init__(self):
        self.updates = {}

    def update(self, name, value):
        self.updates[name] = value


def test_compile_cache_defaults_to_repo_dir():
    cfg = _RecordingConfig()
    path = compile_cache.enable_compile_cache(cfg, environ={})
    assert path == str(REPO / ".jax_cache")
    assert cfg.updates["jax_compilation_cache_dir"] == path
    assert cfg.updates["jax_persistent_cache_min_compile_time_secs"] == 0.0


def test_compile_cache_leaves_env_dir_to_jax():
    cfg = _RecordingConfig()
    path = compile_cache.enable_compile_cache(
        cfg, environ={"JAX_COMPILATION_CACHE_DIR": "/elsewhere/cache"})
    assert path == "/elsewhere/cache"
    assert "jax_compilation_cache_dir" not in cfg.updates
    assert cfg.updates["jax_persistent_cache_min_entry_size_bytes"] == 0


def test_compile_cache_env_dir_receives_entries(tmp_path):
    """A process with JAX_COMPILATION_CACHE_DIR set leaves its compiled
    programs in that directory."""
    code = ("from stm32f4_sdr_gps_tpu.utils.compile_cache import "
            "enable_compile_cache; enable_compile_cache(); import jax; "
            "jax.jit(lambda x: x * 2 + 1)(jax.numpy.ones(8)).block_until_ready()")
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path / "jc"),
               JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120, cwd=tmp_path)
    assert any((tmp_path / "jc").iterdir())


def test_main_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as exc:
        cs.main([])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("line, name, watts", [
    ("NVIDIA H100 80GB HBM3, 700.00 W", "NVIDIA H100 80GB HBM3", 700.0),
    ("NVIDIA H100 80GB HBM3, 400.00 W", "NVIDIA H100 80GB HBM3", 400.0),
    ("NVIDIA H100 PCIe, [N/A]", "NVIDIA H100 PCIe", None),
])
def test_parse_card_line(line, name, watts):
    assert device_info.parse_card_line(line) == (name, watts)


def test_parse_card_line_rejects_other_text():
    with pytest.raises(ValueError):
        device_info.parse_card_line("No devices were found")


def test_result_line_form():
    devices = jax.devices()
    line = cs.result_line(devices)
    assert "\n" not in line
    out = json.loads(line)
    assert out["ok"] is True
    assert out["device"] == {"platform": devices[0].platform,
                             "kind": devices[0].device_kind,
                             "count": len(devices)}


def test_while_body_ops_counts_the_scan():
    from stm32f4_sdr_gps_tpu.runtime.receiver import _track_and_digest
    from stm32f4_sdr_gps_tpu.signal.ca_code import ca_table_bipolar
    from stm32f4_sdr_gps_tpu.track.state import init_state

    st = init_state(4, np.zeros(4), np.zeros(4))
    ep = jnp.zeros((16, BASEBAND_PLAN.samples_per_epoch), jnp.complex64)
    tb = jnp.asarray(ca_table_bipolar([1, 2, 3, 4]))
    text = _track_and_digest.lower(
        st, ep, tb, plan=BASEBAND_PLAN, cfg=TrackConfig(),
        code_filter_len=8, enable_code_filter=True).compile().as_text()
    ops = cs.while_body_ops(text)
    assert ops["fusion"] > 0
    assert 0 < cs.kernel_count(ops) < sum(ops.values())


def test_while_body_ops_descends_into_calls():
    text = """HloModule m

%inner (p: f32[4]) -> f32[4] {
  %p = f32[4]{0} parameter(0)
  ROOT %f = f32[4]{0} fusion(%p), kind=kLoop, calls=%fused
}

%body (t: (s32[], f32[4])) -> (s32[], f32[4]) {
  %t = (s32[], f32[4]{0}) parameter(0)
  %x = f32[4]{0} get-tuple-element(%t), index=1
  %c = f32[4]{0} call(%x), to_apply=%inner
  %y = f32[4]{0} copy(%c)
  ROOT %r = (s32[], f32[4]{0}) tuple(%i, %y)
}

ENTRY %main (a: f32[4]) -> f32[4] {
  %w = (s32[], f32[4]{0}) while(%init), condition=%cond, body=%body
}
"""
    ops = cs.while_body_ops(text)
    assert ops["fusion"] == 1 and ops["copy"] == 1 and "call" not in ops
    assert cs.kernel_count(ops) == 2


@pytest.fixture(scope="module")
def scenario():
    # ~1 s of prefix bits plus five 0.9 s subframes at 3 ms per bit
    return fix_scenario(num_epochs=5200, codes_in_bit=CIB)


@pytest.fixture(scope="module")
def acquired(scenario):
    cpu = jax.devices("cpu")[0]
    res, _ = cs.acquisition_phase(scenario.samples, range(1, 33),
                                  AcqConfig(), BASEBAND_PLAN, cpu, cpu)
    return res


def _compressed_rx_cfg():
    # compressed bits skew the TOW labels against the physics, so the
    # fix is km-scale by construction and the plausibility gates that
    # would reject it are off (signal.scenarios.fix_scenario)
    return ReceiverConfig(
        prns=tuple(range(1, 33)),
        track=TrackConfig(codes_in_bit=CIB, pll_bad_state_threshold=10**9),
        track_block_epochs=500, max_resid_rms_m=0.0, min_altitude_m=0.0,
        max_altitude_m=0.0, grid_fault_search=False)


def test_acquisition_phase_tiny(scenario, acquired):
    cpu = jax.devices("cpu")[0]
    assert sorted(r.prn for r in acquired if r.detected) == \
        sorted(scenario.prns)
    res, rep = cs.acquisition_phase(
        scenario.samples, [2, 7, 11, 15, 24],
        AcqConfig(use_matmul_dft=True, doppler_span_hz=1000.0),
        BASEBAND_PLAN, cpu, cpu)
    assert rep["method"] == "matmul-dft" and rep["bins"] == 5
    assert 11 not in rep["detected"]


@pytest.mark.parametrize("name", ["default", "deep"])
def test_tracking_phase_tiny(scenario, acquired, name):
    cpu = jax.devices("cpu")[0]
    tcfg = TrackConfig(codes_in_bit=CIB) if name == "default" else \
        DEEP_COHERENT_TRACK
    st, table, n_live = cs.handoff_state(scenario.samples, acquired,
                                         BASEBAND_PLAN, tcfg, 8, cpu)
    assert n_live == 4 and table.shape == (8, 1023)
    rep = cs.tracking_phase(scenario.samples, st, table, n_live, tcfg,
                            BASEBAND_PLAN, cpu, cpu, n_epochs=60, repeats=2)
    assert rep["channels"] == 8 and rep["epochs"] == 60
    assert rep["max_doppler_diff_hz"] == 0.0
    assert rep["while_body_kernels"] > 0 and rep["block_s"] > 0
    if name == "default":
        assert rep["bit_events"] > 0


def test_tracking_phase_fails_outside_tolerance(scenario, acquired,
                                                monkeypatch):
    cpu = jax.devices("cpu")[0]
    tcfg = TrackConfig(codes_in_bit=CIB)
    st, table, n_live = cs.handoff_state(scenario.samples, acquired,
                                         BASEBAND_PLAN, tcfg, 4, cpu)
    monkeypatch.setattr(cs, "TRACK_DOPPLER_TOL_HZ", -1.0)
    with pytest.raises(cs.SmokeFailure, match="Doppler"):
        cs.tracking_phase(scenario.samples, st, table, n_live, tcfg,
                          BASEBAND_PLAN, cpu, cpu, n_epochs=20, repeats=1)


def test_cold_fix_phase_tiny(scenario):
    cpu = jax.devices("cpu")[0]
    report, rep = cs.cold_fix_phase(scenario, _compressed_rx_cfg(), cpu,
                                    max_err_m=1e5)
    assert rep["tracked"] == sorted(scenario.prns)
    assert rep["fixes"] >= 1 and rep["compile_s"] >= 0.0
    assert rep["capture_s"] == pytest.approx(5.2)
    with pytest.raises(cs.SmokeFailure, match="from truth"):
        cs.cold_fix_phase(scenario, _compressed_rx_cfg(), cpu, max_err_m=1.0)


def test_four_card_phase_on_virtual_devices(scenario):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    rep = cs.four_card_phase(scenario, _compressed_rx_cfg(),
                             jax.devices()[4:8], max_fix_diff_m=100.0)
    assert rep["mesh"] == {"time": 2, "chan": 2}
    assert rep["acquired"] == sorted(scenario.prns)
