"""Pre-track code-phase refinement.

The firmware refines the coarse acquisition code phase by exhaustively
correlating a +/-15 half-chip zone over ~20-30 rounds spread across TDM
slots, then voting for the longest chain of identical argmax phases
(``tracking.c:398-499``).  Here: correlate the whole zone for all
channels over E epochs in one batched tensor op, integrate power
non-coherently, and take the (interpolated) argmax — same capability, one
program, no state machine.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SignalPlan, TrackConfig
from ..ops.correlate import CORRELATOR_PRECISION
from ..ops.replica import sample_replicas
from ..ops.wipeoff import carrier_wipeoff


@functools.partial(jax.jit, static_argnames=("plan", "num_offsets"))
def _pretrack_power(
    epochs: jnp.ndarray,          # (E, S)
    code_table: jnp.ndarray,      # (C, 1023)
    code_phase: jnp.ndarray,      # (C,)
    doppler_hz: jnp.ndarray,      # (C,)
    plan: SignalPlan,
    num_offsets: int,
) -> jnp.ndarray:
    s_cnt = plan.samples_per_epoch
    offsets = (jnp.arange(num_offsets, dtype=jnp.float32)
               - (num_offsets - 1) / 2.0) * 0.5     # half-chip grid
    code_freq = jnp.full_like(code_phase, plan.chips_per_sample)
    replicas = sample_replicas(code_table, code_phase, code_freq,
                               s_cnt, offsets)      # (C, K, S)

    def per_epoch(acc_phase, x):
        acc, phase = acc_phase
        y, phase = carrier_wipeoff(x, doppler_hz, phase, plan.sample_rate_hz)
        corr = jnp.einsum("cn,ckn->ck", y, replicas.astype(y.dtype),
                          precision=CORRELATOR_PRECISION)
        return (acc + jnp.abs(corr) ** 2, phase), None

    phase0 = jnp.zeros_like(doppler_hz)
    acc0 = jnp.zeros((code_table.shape[0], num_offsets), jnp.float32)
    (acc, _), _ = jax.lax.scan(per_epoch, (acc0, phase0), epochs)
    return acc


def refine_code_phase(
    samples: np.ndarray,
    code_table: np.ndarray,        # (C, 1023) bipolar
    code_phase_chips: np.ndarray,  # (C,) coarse acquisition result
    doppler_hz: np.ndarray,        # (C,)
    plan: SignalPlan,
    cfg: TrackConfig = TrackConfig(),
    num_epochs: int | None = None,
) -> np.ndarray:
    """Return refined (C,) code phases (chips, sub-half-chip accurate)."""
    s_cnt = plan.samples_per_epoch
    e = min(num_epochs or cfg.pre_track_epochs, len(samples) // s_cnt)
    epochs = jnp.asarray(
        samples[: e * s_cnt].reshape(e, s_cnt), jnp.complex64
    )
    k = cfg.pre_track_zone_halfchips + 1
    power = np.asarray(
        _pretrack_power(
            epochs,
            jnp.asarray(code_table),
            jnp.asarray(code_phase_chips, jnp.float32),
            jnp.asarray(doppler_hz, jnp.float32),
            plan,
            k,
        )
    )
    best = power.argmax(axis=1)
    # parabolic interpolation around the peak (clamped at zone edges)
    refined = []
    for c, b in enumerate(best):
        if 0 < b < k - 1:
            ym1, y0, yp1 = power[c, b - 1], power[c, b], power[c, b + 1]
            denom = ym1 - 2 * y0 + yp1
            frac = 0.5 * (ym1 - yp1) / denom if abs(denom) > 1e-12 else 0.0
        else:
            frac = 0.0
        off = (b - (k - 1) / 2.0 + np.clip(frac, -0.5, 0.5)) * 0.5
        refined.append((code_phase_chips[c] + off) % 1023.0)
    return np.asarray(refined)
