"""On-card smoke run: the whole receiver on one GPU, cold start to fix.

    python chip_smoke.py                # phases 1-3 on one GPU
    python chip_smoke.py --four-cards   # phase 4 only, on four GPUs

Every phase drives the package's public entry points at real widths and
compares the GPU with a plain reference: the CPU backend of the same
process (phases 1-2), the planted truth of a simulated capture (phase
3), or the single-GPU receiver (phase 4).

1. Acquisition: ``acquire`` on the default grid (29 Doppler bins x 10
   epochs, all 32 PRNs), FFT path and matmul-DFT path.
2. Tracking: one 1000-epoch, 32-channel ``_track_and_digest`` block (the
   Receiver's per-block program) for the default ``TrackConfig`` and
   ``DEEP_COHERENT_TRACK``; warm time per block, compile time, and the
   number of kernels in the scan's ``while`` body.
3. Cold start to fix: ``Receiver`` over 29 s of 4-satellite 48 dBHz IQ
   with real 20 ms nav bits, all 32 PRNs searched.
4. ``MeshReceiver`` on a (time=2, chan=2) mesh of four GPUs against the
   single-GPU ``Receiver`` on the phase-3 capture.

Each phase is a function of its sizes and devices, so a CPU test can run
it at a tiny size; only :func:`main` requires a GPU.  A failed check
raises, so the script exits non-zero and prints no result line.  The
last line of standard output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import sys
import time
from collections import Counter

import numpy as np

from stm32f4_sdr_gps_tpu.acquire.engine import (
    acquire,
    dft_precision_enum,
    refine_doppler_device,
)
from stm32f4_sdr_gps_tpu.config import (
    BASEBAND_PLAN,
    DEEP_COHERENT_TRACK,
    AcqConfig,
    ReceiverConfig,
    TrackConfig,
)
from stm32f4_sdr_gps_tpu.runtime.receiver import Receiver, _track_and_digest
from stm32f4_sdr_gps_tpu.signal.ca_code import ca_table_bipolar
from stm32f4_sdr_gps_tpu.signal.scenarios import fix_scenario
from stm32f4_sdr_gps_tpu.track.pretrack import refine_code_phase
from stm32f4_sdr_gps_tpu.track.state import init_state
from stm32f4_sdr_gps_tpu.utils.compile_cache import enable_compile_cache
from stm32f4_sdr_gps_tpu.utils.device_info import (
    card_lines,
    device_record,
    require_gpu,
)

# ---- tolerances, each measured on an H100 (CHANGES.md, PR 1) -----------
# Acquisition, GPU against CPU: the same cube; only the FFT's or the
# matmul's summation order (and TF32 inputs on the matmul path at
# "default") differ.  Measured: same bins, code phase identical to the
# sample, interpolated Doppler within 0.01 Hz.  Bound: one sample.
ACQ_CODE_PHASE_TOL_SAMPLES = 1.0
# Tracking, locked channels after one 1000-epoch closed-loop block, GPU
# against CPU.  The correlator contractions run in f32 on both (measured
# bit-identical at DEFAULT and HIGHEST on the card: XLA emits them as
# fused reductions, not tensor-core products), but the GPU sums the 2046
# samples in another order and evaluates sin/cos/atan2 with other
# approximations; the loops turn those last-bit differences into
# different noise trajectories, bounded by the loops' own jitter.
# Measured: 0.12 Hz and 0.025 chip.  Bounds: 1 Hz and 0.1 chip (30 m).
TRACK_DOPPLER_TOL_HZ = 1.0
TRACK_CODE_PHASE_TOL_CHIPS = 0.1
# Phase 4, mesh against one card: the time-sharded acquisition sums its
# epochs in another order (psum), which moves the handoff in its last
# bits; the tracking loops then diverge to their jitter as above,
# amplified by the 4-satellite geometry.  Measured on four H100s: the
# two fixes 2.4 m apart, each ~85 m from truth.  Bound: 25 m.
MESH_FIX_TOL_M = 25.0


class SmokeFailure(AssertionError):
    """A phase's result disagrees with its reference."""


def _require(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def _wrap_chips(d):
    return (np.asarray(d) + 511.5) % 1023.0 - 511.5


@contextlib.contextmanager
def compile_clock():
    """Seconds JAX spends tracing, lowering and compiling inside the
    block (a persistent-cache hit still counts its lookup)."""
    import jax

    events = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")
    total = [0.0]

    def listener(event, duration, **kwargs):  # noqa: ARG001
        if event in events:
            total[0] += duration

    jax.monitoring.register_event_duration_secs_listener(listener)
    try:
        yield total
    finally:
        jax.monitoring.unregister_event_duration_listener(listener)


# ---- HLO inspection ------------------------------------------------------

_NOT_KERNELS = {"parameter", "get-tuple-element", "tuple", "bitcast",
                "constant", "after-all", "partition-id", "replica-id",
                "opt-barrier"}
_HEADER = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$")
_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?[\w.\-]+\s*=\s*(.*)$")
_OPCODE = re.compile(r"(?:^|\s)([a-z][a-z0-9\-]*)\(")


def _computations(hlo_text: str) -> dict:
    """{computation name: [instruction right-hand sides]}."""
    comps, name = {}, None
    for line in hlo_text.splitlines():
        line = re.sub(r"/\*.*?\*/", "", line)
        if name is None:
            m = _HEADER.match(line)
            if m and not line.startswith(" "):
                name = m.group(1)
                comps[name] = []
        elif line.startswith("}"):
            name = None
        else:
            m = _INSTR.match(line)
            if m:
                comps[name].append(m.group(1))
    return comps


def while_body_ops(hlo_text: str) -> Counter:
    """Opcode histogram of the largest ``while`` body in compiled HLO
    (the tracking scan's per-epoch step).  ``call`` and
    ``conditional`` computations run inside the body, so their ops are
    counted in its place; a fusion is one kernel."""
    comps = _computations(hlo_text)
    bodies = [m.group(1) for rhs in sum(comps.values(), [])
              for m in [re.search(r"\bbody=%?([\w.\-]+)", rhs)]
              if m and " while(" in " " + rhs]

    def ops(name, seen=()):
        out = Counter()
        for rhs in comps.get(name, []):
            m = _OPCODE.search(rhs)
            if not m:
                continue
            op = m.group(1)
            if op in ("call", "conditional") and name not in seen:
                subs = re.findall(
                    r"(?:to_apply|branch_computations|true_computation|"
                    r"false_computation)=\{?%?([\w.\-, %]+)\}?", rhs)
                for sub in ",".join(subs).split(","):
                    sub = sub.strip().lstrip("%")
                    if sub:
                        out += ops(sub, seen + (name,))
                continue
            out[op] += 1
        return out

    if not bodies:
        return Counter()
    return max((ops(b) for b in bodies), key=lambda c: sum(c.values()))


def kernel_count(ops: Counter) -> int:
    return sum(n for op, n in ops.items() if op not in _NOT_KERNELS)


# ---- phase 1: acquisition ------------------------------------------------

def acquisition_phase(samples, prns, acq_cfg: AcqConfig, plan, device,
                      reference_device) -> tuple:
    """``acquire`` on ``device`` and on ``reference_device`` with the same
    capture.  Returns (device results, report)."""
    import jax

    runs = []
    for dev in (device, reference_device):
        with jax.default_device(dev):
            runs.append(acquire(samples, list(prns), plan, acq_cfg))
    got, ref = runs
    det = sorted(r.prn for r in got if r.detected)
    det_ref = sorted(r.prn for r in ref if r.detected)
    _require(det == det_ref,
             f"detected PRNs differ: device {det}, reference {det_ref}")
    span, step = acq_cfg.doppler_span_hz, acq_cfg.doppler_step_hz
    max_dop, max_cp = 0.0, 0.0
    for g, r in zip(got, ref):
        if not g.detected:
            continue
        bin_g = round((g.doppler_hz + span) / step)
        bin_r = round((r.doppler_hz + span) / step)
        _require(bin_g == bin_r,
                 f"PRN {g.prn}: Doppler bin {bin_g} vs reference {bin_r}")
        d_cp = abs(float(_wrap_chips(g.code_phase_chips
                                     - r.code_phase_chips)))
        d_samples = d_cp * plan.samples_per_chip
        _require(d_samples <= ACQ_CODE_PHASE_TOL_SAMPLES,
                 f"PRN {g.prn}: code phase off by {d_samples} samples")
        max_dop = max(max_dop, abs(g.doppler_hz - r.doppler_hz))
        max_cp = max(max_cp, d_samples)
    return got, {
        "method": "matmul-dft" if acq_cfg.use_matmul_dft else "fft",
        "precision": (acq_cfg.dft_precision if acq_cfg.use_matmul_dft
                      else "n/a"),
        "prns_searched": len(prns),
        "bins": len(acq_cfg.doppler_bins_hz),
        "epochs": acq_cfg.noncoherent_epochs,
        "detected": det,
        "max_doppler_diff_hz": max_dop,
        "max_code_phase_diff_samples": max_cp,
    }


# ---- phase 2: tracking ---------------------------------------------------

def handoff_state(samples, acq_results, plan, track_cfg: TrackConfig,
                  n_channels: int, device, seed: int = 0) -> tuple:
    """Initial tracking state as the Receiver hands off: fine Doppler
    (refine_doppler_device) and pre-track code phase for the detected
    satellites, plus channels on absent PRNs at random code phase and
    Doppler up to ``n_channels``.  Returns (state, table, n_live)."""
    import jax
    import jax.numpy as jnp

    live = [r for r in acq_results if r.detected]
    _require(live, "nothing acquired to track")
    _require(len(live) <= n_channels, "more satellites than channels")
    absent = [p for p in range(1, 33) if p not in {r.prn for r in live}]
    prns = [r.prn for r in live] + absent[: n_channels - len(live)]
    table = ca_table_bipolar(prns)
    phases = np.array([r.code_phase_chips for r in live])
    spe = plan.samples_per_epoch
    e = min(32, len(samples) // spe)
    with jax.default_device(device):
        dop = np.asarray(refine_doppler_device(
            jnp.asarray(samples[: e * spe].reshape(e, spe), jnp.complex64),
            jnp.asarray(table[: len(live)]),
            jnp.asarray(phases, jnp.float32),
            jnp.asarray([r.doppler_hz for r in live], jnp.float32), plan,
        )).astype(np.float64)
        cp = refine_code_phase(samples, table[: len(live)], phases, dop,
                               plan, track_cfg)
    rng = np.random.default_rng(seed)
    n_ghost = n_channels - len(live)
    cp = np.concatenate([cp, rng.uniform(0, 1023, n_ghost)])
    dop = np.concatenate([dop, rng.uniform(-5000, 5000, n_ghost)])
    state = init_state(n_channels, cp, dop, window=track_cfg.pll_check_window)
    return state, table, len(live)


def tracking_phase(samples, state0, table, n_live: int, track_cfg,
                   plan, device, reference_device, n_epochs: int = 1000,
                   repeats: int = 5) -> dict:
    """One ``_track_and_digest`` block on ``device`` and on
    ``reference_device`` from the same state; compares the digests of
    the first ``n_live`` (locked) channels and times the device."""
    import jax

    spe = plan.samples_per_epoch
    _require(len(samples) >= n_epochs * spe, "capture shorter than block")
    epochs = samples[: n_epochs * spe].reshape(n_epochs, spe)
    epochs = epochs.astype(np.complex64)
    rx_defaults = ReceiverConfig()
    static = dict(plan=plan, cfg=track_cfg,
                  code_filter_len=rx_defaults.code_filter_len,
                  enable_code_filter=rx_defaults.enable_code_filter)

    def run(dev):
        args = jax.device_put((state0, epochs, table), dev)
        t0 = time.perf_counter()
        compiled = _track_and_digest.lower(*args, **static).compile()
        compile_s = time.perf_counter() - t0
        out = jax.block_until_ready(compiled(*args))
        return compiled, args, out, compile_s

    compiled, args, (_, d), compile_s = run(device)
    _, _, (_, d_ref), _ = run(reference_device)
    d = jax.tree.map(np.asarray, d)
    d_ref = jax.tree.map(np.asarray, d_ref)
    for name, leaf in d._asdict().items():
        if leaf.dtype.kind == "f":
            _require(np.isfinite(leaf).all(), f"digest {name} not finite")

    live = slice(0, n_live)
    d_dop = np.abs(d.doppler_hz[live] - d_ref.doppler_hz[live])
    d_cp = np.abs(_wrap_chips(d.code_phase_chips[live]
                              - d_ref.code_phase_chips[live]))
    _require(d_dop.max() <= TRACK_DOPPLER_TOL_HZ,
             f"Doppler differs by {d_dop.max()} Hz")
    _require(d_cp.max() <= TRACK_CODE_PHASE_TOL_CHIPS,
             f"code phase differs by {d_cp.max()} chips")
    for name in ("first_ip_sign", "last_ip_sign", "bit_count",
                 "period_sync_ok"):
        a, b = getattr(d, name)[live], getattr(d_ref, name)[live]
        _require(np.array_equal(a, b), f"{name} differs: {a} vs {b}")
    for c in range(n_live):
        k = int(d.bit_count[c])
        for name in ("bit_value", "bit_epoch"):
            a = getattr(d, name)[:k, c]
            b = getattr(d_ref, name)[:k, c]
            _require(np.array_equal(a, b),
                     f"channel {c}: {name} events differ")

    # warm time per block on the device, state chained block to block
    st, tb_ep = args[0], args[1:]
    t0 = time.perf_counter()
    for _ in range(repeats):
        st, _d = compiled(st, *tb_ep)
    jax.block_until_ready((st, _d))
    block_s = (time.perf_counter() - t0) / repeats
    ops = while_body_ops(compiled.as_text())
    return {
        "channels": int(table.shape[0]), "locked": n_live,
        "epochs": n_epochs,
        "max_doppler_diff_hz": float(d_dop.max()),
        "max_code_phase_diff_chips": float(d_cp.max()),
        "bit_events": int(d.bit_count[live].sum()),
        "compile_s": compile_s, "block_s": block_s,
        "realtime_x": n_epochs * 1e-3 / block_s,
        "while_body_kernels": kernel_count(ops),
        "while_body_ops": dict(ops.most_common()),
    }


# ---- phase 3: cold start to fix ------------------------------------------

def cold_fix_phase(scenario, rx_cfg: ReceiverConfig, device,
                   max_err_m: float) -> tuple:
    """``Receiver(rx_cfg).run`` over the scenario on ``device``; every
    planted satellite must decode a full ephemeris and the last fix
    must lie within ``max_err_m`` of the planted position.  Returns
    (report, summary)."""
    import jax

    with jax.default_device(device), compile_clock() as compile_s:
        t0 = time.perf_counter()
        report = Receiver(rx_cfg).run(scenario.samples)
        wall = time.perf_counter() - t0
    tracked = {ch.prn: ch for ch in report.channels}
    for prn in scenario.prns:
        _require(prn in tracked, f"PRN {prn} was not acquired")
        _require(tracked[prn].eph.has_full_set,
                 f"PRN {prn} decoded no full ephemeris")
    _require(report.solutions, "no position fix")
    err = float(np.linalg.norm(report.solutions[-1].rr - scenario.rr_true))
    _require(err < max_err_m, f"fix {err:.1f} m from truth")
    stats = device.memory_stats() or {}
    capture_s = report.epochs_processed * 1e-3
    run_s = wall - compile_s[0]
    return report, {
        "prns_searched": len(rx_cfg.prns),
        "tracked": sorted(tracked),
        "capture_s": capture_s,
        "wall_s": wall, "compile_s": compile_s[0], "run_s": run_s,
        "realtime_x": capture_s / run_s if run_s > 0 else float("nan"),
        "fix_error_m": err, "fixes": len(report.solutions),
        "peak_bytes_in_use": stats.get("peak_bytes_in_use", "not reported"),
    }


# ---- phase 4: four cards -------------------------------------------------

def four_card_phase(scenario, rx_cfg: ReceiverConfig, devices,
                    max_fix_diff_m: float = MESH_FIX_TOL_M) -> dict:
    """``MeshReceiver`` on a (time=2, chan=2) mesh of ``devices[:4]``
    against the single-device ``Receiver`` on ``devices[0]``."""
    import jax

    from stm32f4_sdr_gps_tpu.parallel.mesh import make_mesh
    from stm32f4_sdr_gps_tpu.runtime.mesh_receiver import MeshReceiver

    _require(len(devices) >= 4, f"needs 4 devices, found {len(devices)}")
    mesh = make_mesh(time=2, chan=2, devices=list(devices[:4]))
    t0 = time.perf_counter()
    rep_mesh = MeshReceiver(rx_cfg, mesh).run(scenario.samples)
    mesh_s = time.perf_counter() - t0
    with jax.default_device(devices[0]):
        t0 = time.perf_counter()
        rep_one = Receiver(rx_cfg).run(scenario.samples)
        one_s = time.perf_counter() - t0
    prns_mesh = [ch.prn for ch in rep_mesh.channels]
    prns_one = [ch.prn for ch in rep_one.channels]
    _require(prns_mesh == prns_one,
             f"acquired PRNs differ: mesh {prns_mesh}, one {prns_one}")
    for chm, ch1 in zip(rep_mesh.channels, rep_one.channels):
        _require(chm.subframe_time_ms == ch1.subframe_time_ms,
                 f"PRN {chm.prn}: subframe time {chm.subframe_time_ms} "
                 f"vs {ch1.subframe_time_ms}")
    _require(rep_mesh.solutions and rep_one.solutions, "no fix")
    d_fix = float(np.linalg.norm(rep_mesh.solutions[-1].rr
                                 - rep_one.solutions[-1].rr))
    _require(d_fix <= max_fix_diff_m,
             f"mesh fix {d_fix:.3f} m from the single-device fix")
    truth = scenario.rr_true
    return {
        "mesh": dict(mesh.shape), "acquired": prns_mesh,
        "subframe_time_ms": [ch.subframe_time_ms for ch in rep_mesh.channels],
        "fix_diff_m": d_fix,
        "mesh_fix_error_m": float(np.linalg.norm(
            rep_mesh.solutions[-1].rr - truth)),
        "one_fix_error_m": float(np.linalg.norm(
            rep_one.solutions[-1].rr - truth)),
        "mesh_wall_s": mesh_s, "one_wall_s": one_s,
    }


# ---- driver ----------------------------------------------------------------

def result_line(devices) -> str:
    return json.dumps({"ok": True, "device": device_record(devices)})


def _report(tag: str, card: str, payload: dict) -> None:
    print(f"{tag} [{card}]: {json.dumps(payload, default=str)}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only phase 4, MeshReceiver over 4 GPUs")
    args = ap.parse_args(argv)

    import jax

    # the CPU backend is the reference of phases 1-2; keep it initialized
    # beside the GPU when the platform list names only the GPU
    plats = jax.config.jax_platforms
    if plats and "cpu" not in plats.split(","):
        jax.config.update("jax_platforms", plats + ",cpu")
    devices = jax.devices()
    require_gpu(devices)
    cache_dir = enable_compile_cache()
    gpu = devices[0]
    print(f"jax {jax.__version__}; {gpu.device_kind} x {len(devices)}; "
          f"compile cache {cache_dir}", flush=True)
    cards = card_lines()
    for line in cards:
        print(line, flush=True)
    card = cards[0]

    plan = BASEBAND_PLAN
    t0 = time.perf_counter()
    sc = fix_scenario(num_epochs=29_000)
    print(f"capture: 29 s, 4 satellites at 48 dBHz, PRNs {sc.prns}, "
          f"simulated in {time.perf_counter() - t0:.1f} s", flush=True)
    rx_cfg = ReceiverConfig(prns=tuple(range(1, 33)), track_block_epochs=1000)

    if args.four_cards:
        _require(len(devices) >= 4, f"--four-cards needs 4 GPUs, "
                 f"found {len(devices)}")
        _report("phase 4 mesh vs one card", card,
                four_card_phase(sc, rx_cfg, devices))
        print(result_line(devices))
        return 0

    cpu = jax.devices("cpu")[0]
    acq_res, rep = acquisition_phase(sc.samples, range(1, 33), AcqConfig(),
                                     plan, gpu, cpu)
    _report("phase 1 acquisition fft, gpu vs cpu", card, rep)
    mm_cfg = AcqConfig(use_matmul_dft=True)
    _, rep = acquisition_phase(sc.samples, range(1, 33), mm_cfg, plan,
                               gpu, cpu)
    rep["lax_precision"] = str(dft_precision_enum(mm_cfg))
    _report("phase 1 acquisition matmul-dft, gpu vs cpu", card, rep)

    for name, tcfg in (("default", TrackConfig()),
                       ("DEEP_COHERENT_TRACK", DEEP_COHERENT_TRACK)):
        state0, table, n_live = handoff_state(sc.samples, acq_res, plan,
                                              tcfg, 32, gpu)
        rep = tracking_phase(sc.samples, state0, table, n_live, tcfg, plan,
                             gpu, cpu)
        _report(f"phase 2 tracking {name}, gpu vs cpu", card, rep)

    _, rep = cold_fix_phase(sc, rx_cfg, gpu, max_err_m=500.0)
    _report("phase 3 cold start to fix", card, rep)
    print(result_line(devices))
    return 0


if __name__ == "__main__":
    sys.exit(main())
