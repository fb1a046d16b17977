"""Device-side block digest: shrink per-block host readback to events.

The default receiver loop pulls every (T, C) tracking output to the
host each block (~2.3 MB per 2000-epoch 32-channel block) even though
the host only consumes ~50 bps/channel of it: nav-bit events, the
last-epoch loop state, and a few windowed statistics.  This module
reduces the whole block ON DEVICE to a fixed-shape digest (~40 kB),
computed inside the same jit as the tracking scan so the raw outputs
never leave the device:

* nav-bit events, compacted to a static capacity of T//codes_in_bit + 2
  per channel (stable argsort trick — XLA has no ragged outputs);
* last-epoch code phase / Doppler / SNR / sync flags;
* the drift-detrended code-phase filter (gps_master_filter_code_phase
  capability, gps_master.c:332-388) evaluated on device;
* M2M4 C/N0 moments over bit-edge-clean epochs (the host previously
  pulled full I/Q prompt streams just to compute two moments);
* the block's Doppler integral (carrier-phase observable increment).

This is the device form of the firmware's ISR→mainline hand-off,
which likewise forwards only decoded bits and loop state, never raw
samples (nav_data.c:46-138 consumes the prompt sign, not the buffer).

The aided-sync/coherent weak-signal chain (runtime.receiver
``_maybe_aided_sync``) is ALSO digest-fed: the prompt sign-flip
histogram mod ``codes_in_bit`` (``flip_hist``, the sufficient statistic
of track.aided_sync.find_bit_boundary), the block-edge signs for
cross-block flips, and the block-start code phase / end-of-block swap
residue the engagement logic needs are all reduced on device — the
(T, C) prompt history never leaves it even at 26-30 dBHz.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import CODE_LENGTH, FREQ_L1_HZ, TrackConfig


class BlockDigest(NamedTuple):
    """Fixed-shape per-block summary (leaves sized (K, C) or (C,))."""

    bit_count: jnp.ndarray       # (C,) i32 — events this block
    bit_value: jnp.ndarray       # (K, C) i8, valid rows < bit_count
    bit_epoch: jnp.ndarray       # (K, C) i32
    code_phase_chips: jnp.ndarray  # (C,) f32 — last epoch
    code_phase_filtered: jnp.ndarray  # (C,) f32 — detrended mean
    doppler_hz: jnp.ndarray      # (C,) f32 — last epoch
    doppler_sum: jnp.ndarray     # (C,) f32 — sum over the block
    snr_db: jnp.ndarray          # (C,) f32 — last epoch
    period_sync_ok: jnp.ndarray  # (C,) bool — last epoch
    sync_any_loss: jnp.ndarray   # (C,) bool — any un-synced epoch
    last_unsync_epoch: jnp.ndarray  # (C,) i32 — block-relative, -1 if none
    cn0_m2: jnp.ndarray          # (C,) f32 — mean prompt power (clean)
    cn0_m4: jnp.ndarray          # (C,) f32 — mean squared power (clean)
    cn0_n: jnp.ndarray           # (C,) i32 — clean epochs used
    # aided-sync statistics (track.aided_sync fed without (T, C) readback)
    flip_hist: jnp.ndarray       # (cib, C) i32 — prompt-I sign flips by
    #                              GLOBAL epoch residue mod codes_in_bit
    first_ip_sign: jnp.ndarray   # (C,) i8 — prompt-I sign, first epoch
    last_ip_sign: jnp.ndarray    # (C,) i8 — prompt-I sign, last epoch
    code_phase_first: jnp.ndarray  # (C,) f32 — code phase at block start
    swap_residue: jnp.ndarray    # (C,) i32 — last_swap_epoch % cib at end


def digest_block(outs, final_state, cfg: TrackConfig, code_filter_len: int,
                 enable_code_filter: bool) -> BlockDigest:
    """Reduce TrackOutputs (T, C) to a BlockDigest — pure jnp, runs
    under the same jit as the tracking scan.  ``final_state`` is the
    TrackState the scan returned (its epoch ledger dates the block and
    its swap ledger locates the current bit grid)."""
    ready = outs.bit_ready
    t_cnt, c_cnt = ready.shape
    # Capacity: one bit per codes_in_bit epochs once synced, plus slack
    # for pre-sync flip re-basing, which can complete spurious short
    # "bits" faster than the bit cadence (nav_data.c:105-129 rebases the
    # boundary on every on-grid flip).  bit_count is clamped to cap so a
    # pathological block drops the LATEST events instead of indexing
    # past the compacted rows.
    cap = t_cnt // max(cfg.codes_in_bit, 1) + 8

    # compact ragged bit events to (cap, C): the k-th ready epoch (in
    # time order) lands in row k.  cumsum + one-hot reduction instead
    # of a stable argsort: a sort lowers to a sorting network, while the
    # one-hot select is a (T, C, cap) elementwise+reduce that fuses.
    # Its cost on the card: not measured.
    bit_count = jnp.minimum(ready.sum(axis=0), cap).astype(jnp.int32)
    row = jnp.cumsum(ready.astype(jnp.int32), axis=0) - 1       # (T, C)
    onehot = ready[:, :, None] & (
        row[:, :, None] == jnp.arange(cap, dtype=jnp.int32)[None, None, :]
    )                                                           # (T, C, cap)
    compact = lambda a: jnp.sum(                                # noqa: E731
        jnp.where(onehot, a.astype(jnp.int32)[:, :, None], 0), axis=0
    ).T                                                         # (cap, C)
    # rows >= bit_count[c] are zero (no one-hot hit) — consumers only
    # read k < bit_count, same contract as the argsort version
    bit_value = compact(outs.bit_value).astype(jnp.int8)
    bit_epoch = compact(outs.bit_epoch)

    # M2M4 C/N0 moments over bit-edge-clean epochs (the edge epoch and
    # its predecessor carry attenuated prompts — receiver._m2m4_cn0)
    nxt = jnp.concatenate(
        [ready[1:], jnp.zeros((1, c_cnt), ready.dtype)], axis=0)
    clean = ~(ready | nxt)
    p = outs.ip * outs.ip + outs.qp * outs.qp
    n_clean = clean.sum(axis=0).astype(jnp.int32)
    denom = jnp.maximum(n_clean.astype(jnp.float32), 1.0)
    m2 = jnp.sum(jnp.where(clean, p, 0.0), axis=0) / denom
    # scale p by 1/m2 before squaring so the f32 fourth moment keeps
    # relative precision independent of signal level
    m2s = jnp.maximum(m2, 1e-20)
    pn = p / m2s[None, :]
    m4 = jnp.sum(jnp.where(clean, pn * pn, 0.0), axis=0) / denom

    # drift-detrended code filter (receiver._filtered_code_phase math)
    cp = outs.code_phase_chips
    dop_last = outs.doppler_hz[-1]
    if enable_code_filter:
        k = min(code_filter_len, t_cnt)
        seg = cp[-k:]
        drift = CODE_LENGTH * dop_last / jnp.float32(FREQ_L1_HZ)
        expected = drift[None, :] * (
            jnp.arange(k, dtype=jnp.float32)[:, None] - (k - 1))
        resid = seg - seg[-1][None, :] - expected
        resid = jnp.mod(resid + CODE_LENGTH / 2,
                        CODE_LENGTH) - CODE_LENGTH / 2
        cp_filt = jnp.mod(seg[-1] + resid.mean(axis=0),
                          jnp.float32(CODE_LENGTH))
    else:
        cp_filt = cp[-1]

    sync = outs.period_sync_ok
    unsync = ~sync
    any_loss = unsync.any(axis=0)
    last_unsync = jnp.where(
        any_loss,
        (t_cnt - 1) - jnp.argmax(unsync[::-1], axis=0).astype(jnp.int32),
        -1,
    )

    # sign-flip histogram by GLOBAL epoch residue mod codes_in_bit — the
    # sufficient statistic of the aided bit-boundary search
    # (track.aided_sync.boundary_from_flip_hist).  The flip entering
    # epoch t lands in bin (epoch0 + t) % cib, matching
    # find_bit_boundary's convention; the block-edge flip (first epoch
    # vs the previous block's last) is added by the host from
    # first/last_ip_sign.
    cib = max(cfg.codes_in_bit, 1)
    epoch0 = final_state.epoch_idx - t_cnt          # (C,) block start
    signs = outs.ip > 0
    flips = signs[1:] != signs[:-1]                 # (T-1, C)
    res = jnp.mod(
        epoch0[None, :] + jnp.arange(1, t_cnt, dtype=jnp.int32)[:, None],
        cib,
    )                                               # (T-1, C)
    onehot = (res[:, :, None]
              == jnp.arange(cib, dtype=jnp.int32)[None, None, :])
    flip_hist = jnp.sum(
        (flips[:, :, None] & onehot).astype(jnp.int32), axis=0
    ).T                                             # (cib, C)
    sgn = lambda v: jnp.where(v > 0, 1, -1).astype(jnp.int8)  # noqa: E731

    return BlockDigest(
        bit_count=bit_count,
        bit_value=bit_value,
        bit_epoch=bit_epoch,
        code_phase_chips=cp[-1],
        code_phase_filtered=cp_filt,
        doppler_hz=dop_last,
        doppler_sum=outs.doppler_hz.sum(axis=0),
        snr_db=outs.snr_db[-1],
        period_sync_ok=sync[-1],
        sync_any_loss=any_loss,
        last_unsync_epoch=last_unsync,
        cn0_m2=m2,
        cn0_m4=m4 * m2s * m2s,
        cn0_n=n_clean,
        flip_hist=flip_hist,
        first_ip_sign=sgn(outs.ip[0]),
        last_ip_sign=sgn(outs.ip[-1]),
        code_phase_first=cp[0],
        swap_residue=jnp.mod(final_state.last_swap_epoch, cib)
        .astype(jnp.int32),
    )


def cn0_from_moments(m2: float, m4: float, n: int,
                     epoch_s: float = 1e-3) -> float:
    """M2M4 C/N0 (dB-Hz) from the digest's moments (matches
    receiver._m2m4_cn0 up to f32 moment accumulation)."""
    import numpy as np

    if n < 16:
        return 0.0
    pd = np.sqrt(max(2.0 * m2 * m2 - m4, 0.0))
    pn = m2 - pd
    if pd <= 0.0 or pn <= 0.0:
        return 0.0
    return float(10.0 * np.log10(pd / pn / epoch_s))
