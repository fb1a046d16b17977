"""Batched multi-channel tracking: one ``lax.scan`` over 1 ms epochs.

Batched re-design of the firmware's tracking fast path
(``tracking.c:92-170`` and the bit-sync part of ``nav_data.c:46-138``):

* all C channels are advanced *every* epoch as a batch axis (the firmware
  time-multiplexes 4 channels over a 17 ms superframe, main.c:140-155);
* E/P/L correlation is a fused replica-gather + carrier-rotation +
  multiply-reduce over the epoch (gps_misc.c hot loops);
* DLL / Costas-PLL / FLL discriminators and gain constants follow
  tracking.c:175-393 (gains in config.TrackConfig, scaled for the 1 kHz
  per-channel update cadence — the firmware closes PLL once per 17 ms);
* the 1 ms loop-closure granularity is preserved: time stays sequential
  inside the scan, parallelism comes from channels (SURVEY.md §7 hard
  part (a)).

The channel axis is shardable across devices (see
``stm32f4_sdr_gps_tpu.parallel``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..config import (
    CODE_LENGTH,
    FREQ_L1_HZ,
    SignalPlan,
    TrackConfig,
)
from ..ops.correlate import epl_correlate
from ..ops.replica import sample_replicas
from ..ops.wipeoff import carrier_wipeoff
from .state import TrackOutputs, TrackState

_HALF = 0.5  # discriminator wrap bound, half-cycles (Costas: mod pi)


def _wrap_half(x):
    """Wrap to (-0.5, 0.5] half-cycle range (the +/-pi/2 folds of
    tracking.c:188-192, 233-242 expressed in cycles)."""
    return x - jnp.round(x)


def _costas_phase_err(ip, qp):
    """atan2-based Costas discriminator in *half-cycles*, range (-0.5, 0.5].

    tracking.c:179-183 computes atan2(QP, IP)/pi with the half-plane flip;
    that equals atan2(QP*sign(IP), |IP|)/pi."""
    return jnp.arctan2(qp * jnp.sign(ip), jnp.abs(ip)) / jnp.pi


def _lcg_uniform(seed: jnp.ndarray) -> jnp.ndarray:
    """Cheap per-channel deterministic uniform in [0,1) from an int32 seed
    (replaces rand() in the false-lock kick, tracking.c:317-323)."""
    s = (seed.astype(jnp.uint32) * jnp.uint32(1664525)
         + jnp.uint32(1013904223))
    s = s ^ (s >> 16)
    s = s * jnp.uint32(2246822519)
    return (s >> 8).astype(jnp.float32) / jnp.float32(1 << 24)


def track_epoch_step(
    state: TrackState,
    x_epoch: jnp.ndarray,          # (S,) complex64 — one 1 ms epoch
    code_table: jnp.ndarray,       # (C, 1023) bipolar
    plan: SignalPlan,
    cfg: TrackConfig,
) -> tuple:
    """Advance all channels one epoch.  Returns (new_state, outputs)."""
    fs = plan.sample_rate_hz
    s_cnt = plan.samples_per_epoch

    # ---- code NCO: carrier-aided code frequency --------------------------
    code_freq_cps = (
        jnp.float32(plan.chips_per_sample)
        * (1.0 + state.doppler_hz / jnp.float32(FREQ_L1_HZ))
    )

    lags = (-cfg.epl_spacing_chips, 0.0, cfg.epl_spacing_chips)
    replicas = sample_replicas(
        code_table, state.code_phase_chips, code_freq_cps, s_cnt, lags
    )

    # ---- carrier NCO wipe-off -------------------------------------------
    y, carrier_phase = carrier_wipeoff(
        x_epoch, state.doppler_hz, state.carrier_phase_cycles, fs
    )

    # ---- E/P/L correlators ----------------------------------------------
    epl = epl_correlate(y, replicas)              # (C, 3) complex
    ie, ip, il = epl[:, 0].real, epl[:, 1].real, epl[:, 2].real
    qe, qp, ql = epl[:, 0].imag, epl[:, 1].imag, epl[:, 2].imag

    # Epochs that may contain a nav-bit edge (known once bit-synced): the
    # sign flip attenuates/distorts the circular correlation inside the
    # window (the effect behind the firmware's accurate-sync ratio logic,
    # nav_data.c:145-218), which biases the discriminators.  Freeze DLL
    # and FLL there.
    rem_pred = jnp.mod(
        state.epoch_idx - state.last_swap_epoch, cfg.codes_in_bit
    )
    edge_zone = state.period_sync_ok & (
        (rem_pred == 0) | (rem_pred == cfg.codes_in_bit - 1)
    )

    # ---- DLL (tracking.c:333-393) ---------------------------------------
    e2 = ie * ie + qe * qe
    l2 = il * il + ql * ql
    code_err_raw = -(e2 - l2) / jnp.maximum(e2 + l2, 1e-12)
    code_err = jnp.where(edge_zone, state.dll_err_prev, code_err_raw)
    dll_delta_fine = (
        cfg.dll_c1 * (code_err - state.dll_err_prev)
        + cfg.dll_c2 * cfg.dt_s * code_err
    )
    dll_delta_fine = jnp.where(edge_zone, 0.0, dll_delta_fine)
    # firmware fine units are 1/16 chip (GPS_FINE_RATIO on half-chips)
    dll_delta_chips = dll_delta_fine / jnp.float32(cfg.fine_ratio)

    # natural code-phase advance over the epoch + DLL correction
    new_code_phase = (
        state.code_phase_chips
        + code_freq_cps * s_cnt
        + dll_delta_chips
    )
    wrapped_phase = jnp.mod(new_code_phase, jnp.float32(CODE_LENGTH))
    # Net wraps beyond the nominal one-code-period advance => the
    # "code phase swap" ledger (gps_master.c:228-247 semantics).
    nominal = state.code_phase_chips + jnp.float32(plan.chips_per_sample) * s_cnt
    code_wrapped = jnp.abs(new_code_phase - nominal) > (CODE_LENGTH / 2)

    # ---- PLL (tracking.c:175-209) ---------------------------------------
    phase_err = _costas_phase_err(ip, qp)           # half-cycles
    pll_c1 = jnp.where(state.period_sync_ok, cfg.pll_narrow_c1, cfg.pll_wide_c1)
    pll_c2 = jnp.where(state.period_sync_ok, cfg.pll_narrow_c2, cfg.pll_wide_c2)
    pll_delta = (
        pll_c1 * _wrap_half(phase_err - state.pll_err_prev)
        + pll_c2 * cfg.dt_s * phase_err
    ) * jnp.float32(cfg.pll_scale)

    # ---- FLL (tracking.c:214-256) ---------------------------------------
    theta = _costas_phase_err(ip, qp)
    freq_diff = _wrap_half(theta - state.fll_theta_prev)
    old_diff = _wrap_half(freq_diff - state.fll_err_prev)
    fll_delta = jnp.where(
        state.fll_primed & ~edge_zone,
        (cfg.fll_c1 * cfg.dt_s * old_diff + cfg.fll_c2 * cfg.dt_s * freq_diff)
        * jnp.float32(cfg.fll_scale),
        0.0,
    )

    # ---- 20 ms coherent PLL (coherent_pll) -------------------------------
    # Once synced, close the Costas loop on the coherent prompt sums of
    # each completed bit instead of per-epoch prompts: the grid is
    # frozen (sign_flip masked below), so the bit boundary is derivable
    # from the un-rebased swap epoch.
    phase_err_store = phase_err
    ext_ip = state.ext_ip_sum
    ext_qp = state.ext_qp_sum
    ext_cnt = state.ext_bit_cnt
    if cfg.coherent_pll:
        in_sync = state.period_sync_ok
        rem_now = jnp.mod(
            state.epoch_idx - state.last_swap_epoch, cfg.codes_in_bit
        )
        bit_done = in_sync & (rem_now < state.old_remainder)
        if cfg.pll_ext_bits > 1:
            # ---- extended K-bit data-wipeoff PLL (pll_ext_bits) ------
            # Each completed bit's coherent prompt vector is
            # sign-decided (the nav-bit decision removes the data
            # modulation) and accumulated; the Costas loop closes on
            # the K-bit coherent sum every K bits.
            d = jnp.where(state.bit_ip_sum >= 0, 1.0, -1.0)
            ext_ip = ext_ip + jnp.where(bit_done, d * state.bit_ip_sum, 0.0)
            ext_qp = ext_qp + jnp.where(bit_done, d * state.bit_qp_sum, 0.0)
            ext_cnt = ext_cnt + bit_done.astype(jnp.int32)
            ext_done = bit_done & (ext_cnt >= cfg.pll_ext_bits)
            perr_ext = _costas_phase_err(ext_ip, ext_qp)
            dt_ext = cfg.pll_ext_bits * cfg.codes_in_bit * cfg.dt_s
            pll_delta_ext = (
                cfg.pll_ext_c1 * _wrap_half(perr_ext - state.pll_err_prev)
                + cfg.pll_ext_c2 * dt_ext * perr_ext
            ) * jnp.float32(cfg.pll_ext_scale)
            pll_delta = jnp.where(
                in_sync, jnp.where(ext_done, pll_delta_ext, 0.0), pll_delta
            )
            phase_err_store = jnp.where(
                in_sync,
                jnp.where(ext_done, perr_ext, state.pll_err_prev),
                phase_err,
            )
            # reset the accumulator after each update; clear stale
            # sums whenever sync is lost
            ext_ip = jnp.where(ext_done | ~in_sync, 0.0, ext_ip)
            ext_qp = jnp.where(ext_done | ~in_sync, 0.0, ext_qp)
            ext_cnt = jnp.where(ext_done | ~in_sync, 0, ext_cnt)
        else:
            perr_bit = _costas_phase_err(state.bit_ip_sum, state.bit_qp_sum)
            dt_bit = cfg.codes_in_bit * cfg.dt_s
            pll_delta_bit = (
                cfg.pll_bit_c1 * _wrap_half(perr_bit - state.pll_err_prev)
                + cfg.pll_bit_c2 * dt_bit * perr_bit
            ) * jnp.float32(cfg.pll_bit_scale)
            pll_delta = jnp.where(
                in_sync, jnp.where(bit_done, pll_delta_bit, 0.0), pll_delta
            )
            phase_err_store = jnp.where(
                in_sync,
                jnp.where(bit_done, perr_bit, state.pll_err_prev),
                phase_err,
            )
        fll_delta = jnp.where(in_sync, 0.0, fll_delta)

    new_doppler = state.doppler_hz + pll_delta + fll_delta

    # ---- false-lock watchdog (tracking.c:261-327) -----------------------
    ip_sign = jnp.where(ip > 0, 1, -1).astype(jnp.int8)
    win = jnp.concatenate(
        [state.ip_sign_window[:, 1:], ip_sign[:, None]], axis=1
    )
    transitions = jnp.sum(
        (win[:, 1:] != win[:, :-1]).astype(jnp.int32), axis=1
    )
    window_end = (state.epoch_idx % cfg.pll_check_window) == (
        cfg.pll_check_window - 1
    )
    bad = transitions > 1
    bad_cnt = jnp.where(
        window_end,
        jnp.where(
            bad,
            jnp.minimum(state.pll_bad_cnt + 1, 10),
            jnp.maximum(state.pll_bad_cnt - 1, 0),
        ),
        state.pll_bad_cnt,
    )
    master = jnp.where(
        window_end & (bad_cnt > 9),
        state.pll_bad_master_cnt + 1,
        jnp.where(window_end & (bad_cnt == 0), 0, state.pll_bad_master_cnt),
    )
    if cfg.coherent_pll:
        # the per-epoch sign-transition statistic is meaningless at the
        # C/N0 this mode targets — freeze the watchdog while synced
        hold = state.period_sync_ok
        win = jnp.where(hold[:, None], state.ip_sign_window, win)
        bad_cnt = jnp.where(hold, state.pll_bad_cnt, bad_cnt)
        master = jnp.where(hold, state.pll_bad_master_cnt, master)
    kick = master > cfg.pll_bad_state_threshold
    rand = _lcg_uniform(state.epoch_idx * 37 + jnp.arange(ip.shape[0]))
    kick_target = state.acq_doppler_hz + (rand - 0.5) * 500.0
    new_doppler = jnp.where(kick, kick_target, new_doppler)
    bad_cnt = jnp.where(kick, 0, bad_cnt)
    master = jnp.where(kick, 0, master)

    # ---- SNR (tracking.c:147-169) ---------------------------------------
    snr_i = state.snr_i_sum + jnp.abs(ip)
    snr_q = state.snr_q_sum + jnp.abs(qp)
    snr_cnt = state.snr_cnt + 1
    snr_done = snr_cnt >= cfg.snr_window_epochs
    snr_db = jnp.where(
        snr_done,
        10.0 * jnp.log10(jnp.maximum(snr_i, 1e-9)
                         / jnp.maximum(snr_q, 1e-9)),
        state.snr_db,
    )
    snr_i = jnp.where(snr_done, 0.0, snr_i)
    snr_q = jnp.where(snr_done, 0.0, snr_q)
    snr_cnt = jnp.where(snr_done, 0, snr_cnt)

    # ---- bit sync (nav_data.c:46-138) -----------------------------------
    cib = cfg.codes_in_bit
    epoch = state.epoch_idx
    sign_flip = ip_sign != state.prev_ip_sign
    if cfg.coherent_bit_vote or cfg.coherent_pll:
        # grid-locked mode: once synced, flips neither rebase the
        # boundary nor feed the sync counters (see config docstring)
        sign_flip = sign_flip & ~state.period_sync_ok
    diff = epoch - state.last_swap_epoch
    rem_at_flip = jnp.mod(diff, cib)
    on_grid = (rem_at_flip <= 1) | (rem_at_flip == cib - 1)
    rpc = jnp.where(
        sign_flip & on_grid,
        jnp.minimum(state.right_period_cnt + 1, 10),
        jnp.where(
            sign_flip,
            jnp.maximum(state.right_period_cnt - 1, 0),
            state.right_period_cnt,
        ),
    )
    sync_ok = jnp.where(
        sign_flip,
        jnp.where(
            rpc > cfg.bit_sync_up,
            True,
            jnp.where(rpc < cfg.bit_sync_down, False, state.period_sync_ok),
        ),
        state.period_sync_ok,
    )
    last_swap = jnp.where(sign_flip, epoch, state.last_swap_epoch)

    # bit extraction: 20 ms majority vote (nav_data.c:223-253), or the
    # sign of the coherent prompt-I sum over the bit (coherent_bit_vote
    # — the full bit-length integration gain reaches the decision)
    remainder = jnp.mod(epoch - last_swap, cib).astype(jnp.int32)
    bit_boundary = sync_ok & (remainder < state.old_remainder)
    if cfg.coherent_bit_vote or cfg.coherent_pll:
        bit_value = (state.bit_ip_sum > 0).astype(jnp.int8)
    else:
        bit_value = (state.bit_pos_cnt > state.bit_neg_cnt).astype(jnp.int8)
    votes = state.bit_pos_cnt + state.bit_neg_cnt
    bit_ready = bit_boundary & (votes > 0)
    bit_epoch = epoch - votes  # epoch at which the completed bit started
    pos_cnt = jnp.where(bit_boundary, 0, state.bit_pos_cnt)
    neg_cnt = jnp.where(bit_boundary, 0, state.bit_neg_cnt)
    pos_cnt = jnp.where(sync_ok & (ip > 0), pos_cnt + 1, pos_cnt)
    neg_cnt = jnp.where(sync_ok & (ip <= 0), neg_cnt + 1, neg_cnt)
    ip_sum = jnp.where(bit_boundary, 0.0, state.bit_ip_sum)
    ip_sum = jnp.where(sync_ok, ip_sum + ip, ip_sum)
    qp_sum = jnp.where(bit_boundary, 0.0, state.bit_qp_sum)
    qp_sum = jnp.where(sync_ok, qp_sum + qp, qp_sum)

    new_state = TrackState(
        carrier_phase_cycles=carrier_phase,
        doppler_hz=new_doppler,
        code_phase_chips=wrapped_phase,
        dll_err_prev=code_err,
        pll_err_prev=phase_err_store,
        fll_theta_prev=theta,
        fll_err_prev=freq_diff,
        fll_primed=jnp.ones_like(state.fll_primed),
        ip_sign_window=win,
        pll_bad_cnt=bad_cnt,
        pll_bad_master_cnt=master,
        acq_doppler_hz=state.acq_doppler_hz,
        snr_i_sum=snr_i,
        snr_q_sum=snr_q,
        snr_cnt=snr_cnt,
        snr_db=snr_db,
        prev_ip_sign=ip_sign,
        last_swap_epoch=last_swap,
        right_period_cnt=rpc,
        period_sync_ok=sync_ok,
        old_remainder=remainder,
        bit_pos_cnt=pos_cnt,
        bit_neg_cnt=neg_cnt,
        bit_ip_sum=ip_sum,
        bit_qp_sum=qp_sum,
        epoch_idx=epoch + 1,
        code_wraps=state.code_wraps + code_wrapped.astype(jnp.int32),
        ext_ip_sum=ext_ip,
        ext_qp_sum=ext_qp,
        ext_bit_cnt=ext_cnt,
    )
    if cfg.emit_correlators:
        diag = dict(ie=ie, qe=qe, il=il, ql=ql)
    else:
        z = jnp.zeros((0,), jnp.float32)
        diag = dict(ie=z, qe=z, il=z, ql=z)
    outputs = TrackOutputs(
        ip=ip, qp=qp, **diag,
        code_phase_chips=state.code_phase_chips,
        doppler_hz=new_doppler,
        snr_db=snr_db,
        bit_ready=bit_ready,
        bit_value=bit_value,
        bit_epoch=bit_epoch,
        period_sync_ok=sync_ok,
        code_wrapped=code_wrapped,
    )
    return new_state, outputs


@functools.partial(jax.jit, static_argnames=("plan", "cfg"))
def track_block(
    state: TrackState,
    epochs: jnp.ndarray,           # (T, S) complex64
    code_table: jnp.ndarray,       # (C, 1023)
    plan: SignalPlan,
    cfg: TrackConfig,
) -> tuple:
    """Scan ``T`` epochs of signal through all channels.

    Returns ``(final_state, TrackOutputs with (T, C) leaves)``.  XLA
    fuses the replica gather, wipe-off and E/P/L reduction of each
    epoch; the loop itself is one ``while`` over epochs.
    """

    def body(st, x):
        return track_epoch_step(st, x, code_table, plan, cfg)

    return jax.lax.scan(body, state, epochs)
