"""Benchmark: the receiver's device stages on one GPU, by wall clock.

    python bench.py [--block-epochs 1000] [--channels 32] [--repeats 10]

One process on JAX's default device, which must be a GPU: without one
the script exits non-zero (nothing falls back to the CPU).  Each stage
is a jitted program, compiled first (compile time reported apart),
warmed up, then called ``repeats`` times; the timed region ends in
``block_until_ready``.  Every stage prints one JSON line naming the
device (platform, device_kind, count) and the card's nvidia-smi name and
power limit.

Stages:
  track/jnp-scan         bare tracking scan (track.scan.track_block)
  track/receiver-digest  the Receiver's per-block program: scan + digest
  acquire/fft            32 PRNs x 29 bins x 10 epochs + peak analysis
  acquire/matmul-dft     the same cube through matmul DFTs
  handoff/pretrack       pre-track code-phase zone search
  handoff/refine-doppler batched fine Doppler, 256 epochs
  handoff/epoch-vote     firmware-threshold epoch-vote detector program

Inputs are white noise from a fixed seed: the stages are timed, not
checked (chip_smoke.py checks results against references).
"""

from __future__ import annotations

import argparse
import functools
import itertools
import json
import time

import numpy as np

from stm32f4_sdr_gps_tpu.acquire.engine import (
    _acquire_fused,
    dft_precision_enum,
    exclusion_lags,
    refine_doppler_device,
)
from stm32f4_sdr_gps_tpu.config import BASEBAND_PLAN, AcqConfig, TrackConfig
from stm32f4_sdr_gps_tpu.ops.correlate import (
    code_fft_conj,
    code_spectrum_conj_matmul,
    dft_tables_device,
    fft_circular_correlate,
    noncoherent_power,
    sampled_code_table,
)
from stm32f4_sdr_gps_tpu.ops.wipeoff import doppler_rotations
from stm32f4_sdr_gps_tpu.runtime.receiver import _track_and_digest
from stm32f4_sdr_gps_tpu.signal.ca_code import ca_table_bipolar
from stm32f4_sdr_gps_tpu.track.pretrack import _pretrack_power
from stm32f4_sdr_gps_tpu.track.scan import track_block
from stm32f4_sdr_gps_tpu.track.state import init_state
from stm32f4_sdr_gps_tpu.utils.compile_cache import enable_compile_cache
from stm32f4_sdr_gps_tpu.utils.device_info import (
    card_lines,
    device_record,
    parse_card_line,
    require_gpu,
)


def time_stage(fn, args, repeats: int, chain: bool = False) -> dict:
    """Compile ``fn`` for ``args``, warm it up, and time ``repeats``
    calls.  With ``chain`` the first output is fed back as the first
    argument (a tracking state advancing block to block)."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(*args))
    t0 = time.perf_counter()
    for _ in range(repeats):
        if chain:
            args = (out[0],) + tuple(args[1:])
        out = compiled(*args)
    jax.block_until_ready(out)
    return {"s_per_call": (time.perf_counter() - t0) / repeats,
            "compile_s": compile_s}


def _noise(key, epochs: int, s: int):
    import jax
    import jax.numpy as jnp

    kr, ki = jax.random.split(key)
    return (jax.random.normal(kr, (epochs, s), jnp.float32)
            + 1j * jax.random.normal(ki, (epochs, s), jnp.float32))


def tracking_stages(n_chan: int, block_epochs: int, repeats: int):
    import jax

    plan, cfg = BASEBAND_PLAN, TrackConfig()
    rng = np.random.default_rng(0)
    table = jax.numpy.asarray(
        ca_table_bipolar([(i % 32) + 1 for i in range(n_chan)]))
    state = init_state(n_chan, rng.uniform(0, 1023, n_chan),
                       rng.uniform(-5000, 5000, n_chan))
    epochs = _noise(jax.random.PRNGKey(0), block_epochs,
                    plan.samples_per_epoch)
    shape = {"channels": n_chan, "epochs": block_epochs}
    r = time_stage(lambda st, ep, tb: track_block(st, ep, tb, plan, cfg),
                   (state, epochs, table), repeats, chain=True)
    yield "track/jnp-scan", shape, r
    r = time_stage(lambda st, ep, tb: _track_and_digest(
        st, ep, tb, plan, cfg, 100, True),
        (state, epochs, table), repeats, chain=True)
    yield "track/receiver-digest", shape, r


def acquisition_stages(repeats: int):
    import jax
    import jax.numpy as jnp

    plan, acq = BASEBAND_PLAN, AcqConfig()
    s = plan.samples_per_epoch
    prns = list(range(1, 33))
    bins = jnp.asarray(np.asarray(acq.doppler_bins_hz, np.float32))
    rot = doppler_rotations(bins, s, plan.sample_rate_hz)
    epochs = _noise(jax.random.PRNGKey(1), acq.noncoherent_epochs, s)
    excl = exclusion_lags(acq, plan)
    shape = {"prns": len(prns), "bins": int(bins.shape[0]),
             "epochs": acq.noncoherent_epochs}

    def program(e, c, r, b, *dft, prec=None):
        return _acquire_fused(e, c, r, b, None, dft or None, coherent=1,
                              n_hyp=1, dft_precision=prec, excl=excl)

    prec = dft_precision_enum(acq)
    r = time_stage(functools.partial(program, prec=prec),
                   (epochs, code_fft_conj(prns, plan), rot, bins), repeats)
    yield "acquire/fft", shape, r
    dft = dft_tables_device(s)
    cfc = code_spectrum_conj_matmul(
        jnp.asarray(sampled_code_table(prns, plan)), *dft)
    r = time_stage(functools.partial(program, prec=prec),
                   (epochs, cfc, rot, bins) + tuple(dft), repeats)
    yield "acquire/matmul-dft", dict(shape, precision=acq.dft_precision), r


def handoff_stages(n_chan: int, repeats: int):
    import jax
    import jax.numpy as jnp

    plan, cfg, acq = BASEBAND_PLAN, TrackConfig(), AcqConfig()
    s = plan.samples_per_epoch
    prns = [(i % 32) + 1 for i in range(n_chan)]
    table = jnp.asarray(ca_table_bipolar(prns))
    rng = np.random.default_rng(3)
    cps = jnp.asarray(rng.uniform(0, 1023, n_chan), jnp.float32)
    dops = jnp.asarray(rng.uniform(-5e3, 5e3, n_chan), jnp.float32)
    k = cfg.pre_track_zone_halfchips + 1

    e = cfg.pre_track_epochs
    r = time_stage(lambda ep, t, c, d: _pretrack_power(ep, t, c, d, plan, k),
                   (_noise(jax.random.PRNGKey(4), e, s), table, cps, dops),
                   repeats)
    yield "handoff/pretrack", {"channels": n_chan, "epochs": e}, r

    e = 256
    r = time_stage(lambda ep, t, c, d: refine_doppler_device(
        ep, t, c, d, plan),
        (_noise(jax.random.PRNGKey(5), e, s), table, cps, dops), repeats)
    yield "handoff/refine-doppler", {"channels": n_chan, "epochs": e}, r

    bins = jnp.asarray(np.asarray(acq.doppler_bins_hz, np.float32))
    rot = doppler_rotations(bins, s, plan.sample_rate_hz)
    cfc = code_fft_conj(list(range(1, 33)), plan)

    def vote_program(epochs, cfc_, rot_):
        # acquisition.c:249-274 acceptance rule's per-epoch argmax map
        def per_epoch(x):
            pw = noncoherent_power(fft_circular_correlate(x[None] * rot_,
                                                          cfc_))
            return pw.argmax(axis=2).T, pw.max(axis=2).T

        return jax.lax.map(per_epoch, epochs)

    e = acq.noncoherent_epochs
    r = time_stage(vote_program,
                   (_noise(jax.random.PRNGKey(6), e, s), cfc, rot), repeats)
    yield "handoff/epoch-vote", {"prns": 32, "epochs": e}, r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--block-epochs", type=int, default=1000)
    ap.add_argument("--channels", type=int, default=32)
    ap.add_argument("--repeats", type=int, default=10)
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    require_gpu(devices)
    enable_compile_cache()
    card = card_lines()[0]
    _, limit_w = parse_card_line(card)
    common = {"device": device_record(devices), "card": card,
              "power_limit_w": limit_w}
    stages = itertools.chain(
        tracking_stages(args.channels, args.block_epochs, args.repeats),
        acquisition_stages(args.repeats),
        handoff_stages(args.channels, args.repeats))
    for name, shape, r in stages:
        line = {"stage": name, **shape, **r}
        if name.startswith("track/"):
            line["realtime_x"] = shape["epochs"] * 1e-3 / r["s_per_call"]
        print(json.dumps({**line, **common}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
