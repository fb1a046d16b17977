"""Device-side C/A replica sampling (the "code NCO").

Vectorized replacement for ``gps_generate_prn_data2``
(``gps_misc.c:282-300``): instead of expanding 1023 chips into a 16 kbit
bit-buffer with an integer sub-chip shift, we gather the bipolar code at a
*fractional* code phase for all channels and all correlator lags at once.
The E/P/L lags are expressed as code-phase offsets (+/-0.5 chip by
default, tracking.c:122-138 uses byte offsets +/-1 = +/-0.5 chip).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import CODE_LENGTH


def sample_replicas(
    code_table: jnp.ndarray,       # (C, 1023) bipolar float32
    code_phase_chips: jnp.ndarray,  # (C,) code phase at sample 0
    code_freq_chips_per_sample: jnp.ndarray,  # (C,) incl. code Doppler
    num_samples: int,
    lag_offsets_chips,              # (L,) e.g. (-0.5, 0.0, +0.5)
) -> jnp.ndarray:
    """Return (C, L, num_samples) sampled bipolar replicas.

    Sample ``k`` of lag ``l`` reads chip
    ``floor(phase + lag[l] + k * freq) mod 1023``.  A positive ``lag``
    samples *later* code (an "early" correlator replica leads the prompt,
    i.e. uses a negative offset).
    """
    lags = jnp.asarray(lag_offsets_chips, dtype=jnp.float32)
    k = jnp.arange(num_samples, dtype=jnp.float32)
    chip = (
        code_phase_chips[:, None, None]
        + lags[None, :, None]
        + code_freq_chips_per_sample[:, None, None] * k[None, None, :]
    )
    idx = jnp.floor(chip).astype(jnp.int32) % CODE_LENGTH

    def gather_one(table_c, idx_c):
        return table_c[idx_c]

    return jax.vmap(gather_one)(code_table, idx)
