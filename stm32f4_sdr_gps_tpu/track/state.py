"""Tracking channel state pytree.

The batched equivalent of ``gps_tracking_t`` + the bit-sync half of
``gps_nav_data_t`` (gps_misc.h:62-133).  All leaves carry a leading
channel axis so N channels advance *every* epoch as a batch — no TDM
multiplexing, no NCO phase rewind (SURVEY.md §2.3).  The whole state is a
serializable pytree (checkpoint/resume, SURVEY.md §5).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..config import CODE_LENGTH, TrackConfig


class TrackState(NamedTuple):
    """Per-channel tracking loop state; every field has shape (C,) unless
    noted."""

    # NCOs
    carrier_phase_cycles: jnp.ndarray     # f32, wrapped to [0,1)
    doppler_hz: jnp.ndarray               # f32, carrier offset estimate
    code_phase_chips: jnp.ndarray         # f32, phase at epoch start [0,1023)
    # Loop filter memories (tracking.c fields)
    dll_err_prev: jnp.ndarray             # f32  (dll_code_err)
    pll_err_prev: jnp.ndarray             # f32  (pll_code_err, half-cycles)
    fll_theta_prev: jnp.ndarray           # f32  (atan(Q/I) of prev epoch)
    fll_err_prev: jnp.ndarray             # f32  (fll_err)
    fll_primed: jnp.ndarray               # bool (have a previous theta)
    # False-lock watchdog (tracking.c:261-327)
    ip_sign_window: jnp.ndarray           # (C, W) i8 of IP signs
    pll_bad_cnt: jnp.ndarray              # i32
    pll_bad_master_cnt: jnp.ndarray       # i32
    acq_doppler_hz: jnp.ndarray           # f32, acquisition result (kick anchor)
    # SNR estimator (tracking.c:147-169)
    snr_i_sum: jnp.ndarray                # f32
    snr_q_sum: jnp.ndarray                # f32
    snr_cnt: jnp.ndarray                  # i32
    snr_db: jnp.ndarray                   # f32
    # Bit sync (nav_data.c:46-138)
    prev_ip_sign: jnp.ndarray             # i8 (+1/-1)
    last_swap_epoch: jnp.ndarray          # i32, epoch of last sign swap
    right_period_cnt: jnp.ndarray         # i32
    period_sync_ok: jnp.ndarray           # bool
    old_remainder: jnp.ndarray            # i32
    bit_pos_cnt: jnp.ndarray              # i32
    bit_neg_cnt: jnp.ndarray              # i32
    bit_ip_sum: jnp.ndarray               # f32 coherent prompt-I sum over
    #                                       the current bit (coherent_bit_vote)
    bit_qp_sum: jnp.ndarray               # f32 coherent prompt-Q sum
    #                                       (coherent_pll discriminator)
    # Ledger
    epoch_idx: jnp.ndarray                # i32, global epoch counter
    code_wraps: jnp.ndarray               # i32, net code-phase wraps (swap flag ledger)
    # Extended multi-bit coherent PLL (cfg.pll_ext_bits > 1): K-bit
    # data-wipeoff accumulator of sign-decided bit prompt vectors
    ext_ip_sum: jnp.ndarray               # f32
    ext_qp_sum: jnp.ndarray               # f32
    ext_bit_cnt: jnp.ndarray              # i32, bits accumulated so far


class TrackOutputs(NamedTuple):
    """Per-epoch observables emitted by the scan, each (T, C).

    The E/L correlator outputs are diagnostics; production consumers
    (receiver, bench) only need the prompt + loop states, so E/L are
    emitted as zero-size placeholders unless cfg.emit_correlators."""

    ip: jnp.ndarray
    qp: jnp.ndarray
    ie: jnp.ndarray
    qe: jnp.ndarray
    il: jnp.ndarray
    ql: jnp.ndarray
    code_phase_chips: jnp.ndarray
    doppler_hz: jnp.ndarray
    snr_db: jnp.ndarray
    bit_ready: jnp.ndarray     # bool: a 20 ms nav bit completed this epoch
    bit_value: jnp.ndarray     # i8 0/1 (majority vote, pre-polarity)
    bit_epoch: jnp.ndarray     # i32 epoch index at which the bit *started*
    period_sync_ok: jnp.ndarray
    code_wrapped: jnp.ndarray  # bool: code phase wrapped this epoch


def concat_states(a: TrackState, b: TrackState) -> TrackState:
    """Concatenate two channel batches (late-rising satellite handoff:
    new channels join the live scan state along the channel axis)."""
    import jax

    return jax.tree.map(
        lambda x, y: jnp.concatenate([x, y], axis=0), a, b
    )


def init_state(
    num_channels: int,
    code_phase_chips: np.ndarray,
    doppler_hz: np.ndarray,
    start_epoch: int = 0,
    window: int | None = None,
) -> TrackState:
    """``window`` = watchdog sign-window width; must equal the
    TrackConfig.pll_check_window the state will be scanned with."""
    c = num_channels
    if window is None:
        window = TrackConfig().pll_check_window
    f32 = lambda v: jnp.asarray(np.broadcast_to(v, (c,)), jnp.float32)
    i32z = jnp.zeros((c,), jnp.int32)
    return TrackState(
        carrier_phase_cycles=jnp.zeros((c,), jnp.float32),
        doppler_hz=f32(doppler_hz),
        code_phase_chips=f32(np.asarray(code_phase_chips) % CODE_LENGTH),
        dll_err_prev=jnp.zeros((c,), jnp.float32),
        pll_err_prev=jnp.zeros((c,), jnp.float32),
        fll_theta_prev=jnp.zeros((c,), jnp.float32),
        fll_err_prev=jnp.zeros((c,), jnp.float32),
        fll_primed=jnp.zeros((c,), bool),
        ip_sign_window=jnp.zeros((c, window), jnp.int8),
        pll_bad_cnt=i32z,
        pll_bad_master_cnt=i32z,
        acq_doppler_hz=f32(doppler_hz),
        snr_i_sum=jnp.zeros((c,), jnp.float32),
        snr_q_sum=jnp.zeros((c,), jnp.float32),
        snr_cnt=i32z,
        snr_db=jnp.zeros((c,), jnp.float32),
        prev_ip_sign=jnp.ones((c,), jnp.int8),
        last_swap_epoch=jnp.full((c,), start_epoch, jnp.int32),
        right_period_cnt=i32z,
        period_sync_ok=jnp.zeros((c,), bool),
        old_remainder=i32z,
        bit_pos_cnt=i32z,
        bit_neg_cnt=i32z,
        bit_ip_sum=jnp.zeros((c,), jnp.float32),
        bit_qp_sum=jnp.zeros((c,), jnp.float32),
        epoch_idx=jnp.full((c,), start_epoch, jnp.int32),
        code_wraps=i32z,
        ext_ip_sum=jnp.zeros((c,), jnp.float32),
        ext_qp_sum=jnp.zeros((c,), jnp.float32),
        ext_bit_cnt=i32z,
    )
