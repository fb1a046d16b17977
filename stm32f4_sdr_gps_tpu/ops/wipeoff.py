"""Carrier NCO wipe-off.

Vectorized replacement for the firmware's binary quarter-rate NCO
(``gps_misc.c:211-274``): an exact complex rotation at the tracked Doppler
with phase carried across epochs (the firmware keeps phase in a 32-bit
accumulator, ``if_freq_accum``; we keep fractional cycles, wrapped each
epoch so float32 stays accurate indefinitely).  There is no need for the
firmware's phase "rewind" (``gps_rewind_if_phase``, gps_misc.c:196-204)
because channels are batched, not time-multiplexed.
"""

from __future__ import annotations

import jax.numpy as jnp


def carrier_wipeoff(
    x: jnp.ndarray,                # (n,) or (C, n) complex input
    freq_hz: jnp.ndarray,          # (C,) carrier offset to remove
    phase_cycles: jnp.ndarray,     # (C,) carrier phase at sample 0
    sample_rate_hz: float,
) -> tuple:
    """Rotate the carrier off: y = x * exp(-j*2pi*(phase + f*t)).

    Returns ``(y, end_phase_cycles)`` where ``y`` is (C, n) and
    ``end_phase_cycles`` is the (wrapped) phase at sample n, for carrying
    into the next epoch.
    """
    n = x.shape[-1]
    t = jnp.arange(n, dtype=jnp.float32) / jnp.float32(sample_rate_hz)
    # Wrap the per-sample phase ramp into [0, 1) cycles before exp so the
    # float32 argument never grows (freq * t can reach ~5 cycles/epoch).
    ph = phase_cycles[:, None] + freq_hz[:, None] * t[None, :]
    ph = ph - jnp.floor(ph)
    rot = jnp.exp(jnp.complex64(-2j * jnp.pi) * ph.astype(jnp.complex64))
    y = jnp.atleast_2d(x) * rot
    end = phase_cycles + freq_hz * (n / sample_rate_hz)
    end = end - jnp.floor(end)
    return y, end


def doppler_rotations(
    doppler_bins_hz: jnp.ndarray,  # (D,)
    num_samples: int,
    sample_rate_hz: float,
) -> jnp.ndarray:
    """(D, n) complex64 rotation table exp(-j*2pi*f_d*t) for acquisition."""
    t = jnp.arange(num_samples, dtype=jnp.float32) / jnp.float32(sample_rate_hz)
    ph = doppler_bins_hz[:, None] * t[None, :]
    ph = ph - jnp.floor(ph)
    return jnp.exp(jnp.complex64(-2j * jnp.pi) * ph.astype(jnp.complex64))
