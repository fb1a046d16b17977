"""FFT-parallel acquisition engine.

Replaces the firmware's four-stage serial search
(``acquisition.c``: frequency scan 29 bins x 10 epochs with sort-chain
voting, then three shrinking code-phase searches with histogram voting,
~minutes of wall time) with a single tensor program: the whole
(PRN x Doppler x code-lag) cube is evaluated by FFT circular correlation,
``vmap``-ed over Doppler and PRN, with non-coherent accumulation over
epochs via ``lax.scan``.  Detection is peak / second-peak (the standard
SDR test); an epoch-voting mode compatible with the firmware's histogram
acceptance thresholds (acquisition.c:249-274) is provided for parity
testing.

The PRN axis is shardable across a device mesh — see
``stm32f4_sdr_gps_tpu.parallel``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..config import AcqConfig, SignalPlan, BASEBAND_PLAN, FREQ_L1_HZ
from ..ops.correlate import (
    code_fft_conj,
    code_spectrum_conj_matmul,
    dft_tables_device,
    fft_circular_correlate,
    lag_to_code_phase,
    matmul_circular_correlate,
    noncoherent_power,
    pack_code_bits,
    unpack_code_table,
)
from ..ops.wipeoff import doppler_rotations


@dataclass
class AcqResult:
    """Acquisition verdict for one PRN (cf. gps_acq_t, gps_misc.h:43-60)."""

    prn: int
    detected: bool
    doppler_hz: float           # found_freq_offset_hz equivalent
    code_phase_chips: float     # found_code_phase equivalent (fractional)
    peak_power: float
    peak_ratio: float           # peak / second peak (hist_ratio equivalent)
    peak_to_mean: float


def dft_precision_enum(cfg: AcqConfig):
    """Map AcqConfig.dft_precision to the lax matmul precision used by
    the matmul-DFT contractions.  On an H100 "default" runs the f32
    products in TF32 (10-bit mantissa inputs, f32 accumulation) and
    "highest" in full f32; the CPU backend computes f32 either way.
    Detection statistics under input rounding agree with f32 to ~1e-3
    (reduced-precision emulation test in tests/test_acquisition.py)."""
    return {"highest": jax.lax.Precision.HIGHEST,
            "default": jax.lax.Precision.DEFAULT}[cfg.dft_precision]


@functools.partial(jax.jit,
                   static_argnames=("coherent", "dft_precision"))
def acquisition_power(
    epochs: jnp.ndarray,        # (E, S) complex epochs
    cfc: jnp.ndarray,           # (P, S) conj code FFTs
    rot: jnp.ndarray,           # (D, S) Doppler rotations
    coherent: int = 1,
    dft: tuple | None = None,   # (wc, ws) from ops.correlate.dft_tables
    dft_precision=jax.lax.Precision.HIGHEST,
) -> jnp.ndarray:
    """Non-coherently accumulated correlation power, shape (P, D, S).

    Scans over epoch blocks so peak memory stays at one (D, P, S) complex
    cube; with ``coherent > 1`` the complex correlations of that many
    consecutive epochs are summed before squaring.  The coherent sum
    applies the inter-epoch carrier phasor of each Doppler bin (each
    epoch's rotation restarts at phase 0, so epoch k of bin d carries an
    extra e^{-j*2pi*f_d*k*T} that must be compensated or the coherent
    gain cancels itself).  Coherent spans must stay within a nav bit.
    """
    e, s = epochs.shape
    blocks = epochs[: (e // coherent) * coherent].reshape(-1, coherent, s)

    # inter-epoch phasor per Doppler bin: rot[d, 1] is the per-sample
    # step e^{-j*2pi*f_d/fs}; raising to S gives the per-epoch advance
    if coherent > 1:
        ang1 = jnp.angle(rot[:, 1])                        # -2*pi*f_d/fs
        k = jnp.arange(coherent, dtype=jnp.float32)
        phasor = jnp.exp(
            1j * ang1[None, :] * (s * k[:, None])
        ).astype(rot.dtype)                                # (co, D)
    else:
        phasor = jnp.ones((1, rot.shape[0]), rot.dtype)

    def body(acc, block):
        xd = block[:, None, :] * rot[None, :, :]          # (co, D, S)
        if dft is not None:                               # matmul-DFT
            corr = matmul_circular_correlate(xd, cfc, *dft,
                                             precision=dft_precision)
        else:
            corr = fft_circular_correlate(xd, cfc)         # (co, D, P, S)
        csum = (corr * phasor[:, :, None, None]).sum(axis=0)
        return acc + noncoherent_power(csum).transpose(1, 0, 2), None

    p, d = cfc.shape[0], rot.shape[0]
    acc0 = jnp.zeros((p, d, s), dtype=jnp.float32)
    acc, _ = jax.lax.scan(body, acc0, blocks)
    return acc


@functools.partial(jax.jit,
                   static_argnames=("coherent", "n_hyp", "dft_precision"))
def acquisition_power_hypotheses(
    epochs: jnp.ndarray,        # (E, S) complex epochs
    cfc: jnp.ndarray,           # (P, S) conj code FFTs
    rot: jnp.ndarray,           # (D, S) Doppler rotations
    coherent: int,
    n_hyp: int,
    dft: tuple | None = None,
    dft_precision=jax.lax.Precision.HIGHEST,
) -> jnp.ndarray:
    """All bit-edge hypotheses in ONE device program, shape (P, D, S).

    The coherent block grid is tried at ``n_hyp`` offsets across one
    block and the per-block-normalized powers are max-combined ON
    DEVICE — one dispatch, no host round trips between hypotheses (the
    ULTRA_ACQ 20 ms x 10-hypothesis mode used to be n_hyp sequential
    dispatches with host max-combining).  Hypotheses are unrolled
    program steps rather than a batch axis so peak memory stays at one
    (coherent, D, P, S) correlation cube, same as a single-hypothesis
    run.  Offsets/combining semantics identical to the host loop in
    :func:`acquire`.
    """
    e, _ = epochs.shape
    power = None
    for j in range(n_hyp):
        o = (j * coherent) // n_hyp
        n_blocks = (e - o) // coherent
        if n_blocks < 1:
            continue
        pw = acquisition_power(
            jax.lax.slice_in_dim(epochs, o, o + n_blocks * coherent),
            cfc, rot, coherent=coherent, dft=dft,
            dft_precision=dft_precision,
        ) / float(n_blocks)
        power = pw if power is None else jnp.maximum(power, pw)
    return power


def _parabolic_offset_jnp(ym1, y0, yp1):
    denom = ym1 - 2.0 * y0 + yp1
    return jnp.where(jnp.abs(denom) > 1e-12, 0.5 * (ym1 - yp1) / denom, 0.0)


def exclusion_lags(cfg: AcqConfig, plan: SignalPlan) -> int:
    """Second-peak exclusion half-width in lag samples (shared by
    analyze_power and the benchmark's traced program so the two can't
    drift)."""
    return max(1, int(round(cfg.exclude_chips * plan.samples_per_chip)))


@functools.partial(jax.jit, static_argnames=("excl",))
def analyze_power_device(
    power: jnp.ndarray,         # (P, D, S) non-coherent power cube
    doppler_bins_hz: jnp.ndarray,   # (D,)
    excl: int,                  # exclusion half-width, lag samples
):
    """Peak detection + sub-bin interpolation ON the device.

    The (P, D, S) cube never leaves the accelerator; only (P,)-vectors
    (peak, fractional lag, interpolated Doppler, second peak outside the
    exclusion zone, cube mean) come back — ~200 bytes instead of 7.6 MB,
    which is what a device-resident receiver needs, and what the
    mesh-sharded acquisition reduces over devices without a host
    gather.  Numerics
    mirror host ``analyze_power`` (same argmax tie-break, parabolic
    interpolation, wraparound exclusion distance).
    """
    p_cnt, d_cnt, s = power.shape
    pidx = jnp.arange(p_cnt)
    flat = jnp.argmax(power.reshape(p_cnt, d_cnt * s), axis=1)
    di = flat // s
    si = flat % s
    rows = power[pidx, di]                             # (P, S) best bin
    peak = rows[pidx, si]

    # fractional code lag along the lag axis at the best Doppler row
    frac = _parabolic_offset_jnp(
        rows[pidx, (si - 1) % s], peak, rows[pidx, (si + 1) % s])
    lag = si.astype(jnp.float32) + jnp.clip(frac, -0.5, 0.5)

    # fractional Doppler across bins at the peak lag (interior bins only)
    cols = jnp.take_along_axis(
        power, si[:, None, None], axis=2)[..., 0]      # (P, D)
    dm1 = cols[pidx, jnp.maximum(di - 1, 0)]
    dp1 = cols[pidx, jnp.minimum(di + 1, d_cnt - 1)]
    interior = (di > 0) & (di < d_cnt - 1)
    dfrac = jnp.where(
        interior, jnp.clip(_parabolic_offset_jnp(dm1, peak, dp1), -0.5, 0.5),
        0.0)
    step = (doppler_bins_hz[1] - doppler_bins_hz[0]) if d_cnt > 1 else 0.0
    doppler = doppler_bins_hz[di] + dfrac * step

    # second peak outside the (wraparound) exclusion zone -> detect ratio
    lag_idx = jnp.arange(s)
    dist = jnp.minimum((lag_idx[None, :] - si[:, None]) % s,
                       (si[:, None] - lag_idx[None, :]) % s)
    masked = jnp.where(dist[:, None, :] > excl, power, 0.0)
    second = jnp.max(masked, axis=(1, 2))
    mean = jnp.mean(power, axis=(1, 2))
    return peak, lag, doppler, second, mean


def _analyze_power_host(power: np.ndarray, doppler_bins_hz: np.ndarray,
                        excl: int):
    """Pure-numpy mirror of analyze_power_device (same argmax
    tie-break, parabolic interpolation, wraparound exclusion)."""
    p_cnt, d_cnt, s = power.shape
    pidx = np.arange(p_cnt)
    flat = power.reshape(p_cnt, -1).argmax(axis=1)
    di = flat // s
    si = flat % s
    rows = power[pidx, di]
    peak = rows[pidx, si]

    def parab(ym1, y0, yp1):
        den = ym1 - 2.0 * y0 + yp1
        with np.errstate(divide="ignore", invalid="ignore"):
            out = np.where(np.abs(den) > 1e-12, 0.5 * (ym1 - yp1) / den, 0.0)
        return out

    frac = parab(rows[pidx, (si - 1) % s], peak, rows[pidx, (si + 1) % s])
    lag = si.astype(np.float32) + np.clip(frac, -0.5, 0.5)
    cols = np.take_along_axis(power, si[:, None, None], axis=2)[..., 0]
    dm1 = cols[pidx, np.maximum(di - 1, 0)]
    dp1 = cols[pidx, np.minimum(di + 1, d_cnt - 1)]
    interior = (di > 0) & (di < d_cnt - 1)
    dfrac = np.where(interior, np.clip(parab(dm1, peak, dp1), -0.5, 0.5),
                     0.0)
    step = (doppler_bins_hz[1] - doppler_bins_hz[0]) if d_cnt > 1 else 0.0
    doppler = doppler_bins_hz[di] + dfrac * step
    lag_idx = np.arange(s)
    dist = np.minimum((lag_idx[None, :] - si[:, None]) % s,
                      (si[:, None] - lag_idx[None, :]) % s)
    masked = np.where(dist[:, None, :] > excl, power, 0.0)
    second = masked.max(axis=(1, 2))
    mean = power.mean(axis=(1, 2))
    return peak, lag, doppler, second, mean


def _results_from_vectors(vecs, prns, plan: SignalPlan,
                          cfg: AcqConfig) -> list:
    """(peak, lag, doppler, second, mean) host vectors -> AcqResults
    (thresholding shared by analyze_power and the fused acquire)."""
    peak, lag, doppler, second, mean = vecs
    code_phase = lag_to_code_phase(lag, plan) % 1023.0
    results = []
    for pi in range(len(prns)):
        ratio = float(peak[pi]) / max(float(second[pi]), 1e-20)
        results.append(
            AcqResult(
                prn=int(prns[pi]),
                detected=bool(ratio >= cfg.detect_ratio),
                doppler_hz=float(doppler[pi]),
                code_phase_chips=float(code_phase[pi]),
                peak_power=float(peak[pi]),
                peak_ratio=ratio,
                peak_to_mean=float(peak[pi]) / max(float(mean[pi]), 1e-20),
            )
        )
    return results


def _hint_mask(prns, bins, doppler_hints_hz, cfg: AcqConfig):
    """(P, D) keep-mask confining hinted PRNs to hint +/- one bin, or
    None when no hints apply (main.c:59-73, acquisition.c:72-79)."""
    if not doppler_hints_hz:
        return None
    keep = np.ones((len(prns), len(bins)), dtype=np.float32)
    for pi, prn in enumerate(prns):
        hint = doppler_hints_hz.get(int(prn))
        if hint is not None:
            keep[pi] = np.abs(bins - hint) <= cfg.doppler_step_hz * 1.01
    return keep


def analyze_power(
    power,                      # (P, D, S) device or host array
    prns,
    doppler_bins_hz: np.ndarray,
    plan: SignalPlan,
    cfg: AcqConfig,
) -> list:
    """Peak detection + sub-bin interpolation; cube math on device.

    Thin host wrapper over ``analyze_power_device``: only the per-PRN
    scalar vectors (~200 bytes) are transferred, then thresholded into
    AcqResults.  A host-numpy cube skips the device round trip.
    """
    excl = exclusion_lags(cfg, plan)
    bins_np = np.asarray(doppler_bins_hz, dtype=np.float32)
    if isinstance(power, np.ndarray):
        peak, lag, doppler, second, mean = _analyze_power_host(
            power, bins_np, excl)
    else:
        peak, lag, doppler, second, mean = (
            np.asarray(v) for v in analyze_power_device(
                jnp.asarray(power), jnp.asarray(bins_np), excl))
    return _results_from_vectors((peak, lag, doppler, second, mean),
                                 prns, plan, cfg)


def acquire(
    samples: np.ndarray,
    prns,
    plan: SignalPlan = BASEBAND_PLAN,
    cfg: AcqConfig = AcqConfig(),
    num_epochs: int | None = None,
    doppler_hints_hz: dict | None = None,
) -> list:
    """Cold-start acquisition of ``prns`` from a capture.

    Uses ``cfg.noncoherent_epochs`` 1 ms epochs (the firmware integrates
    10 epochs per Doppler bin, acquisition.c:18).

    ``doppler_hints_hz`` maps PRN -> expected Doppler; a hinted channel's
    search is confined to hint +/- one bin — the capability of the
    firmware's user-supplied hints that skip the frequency search
    entirely (main.c:59-73, acquisition.c:72-79).
    """
    s = plan.samples_per_epoch
    e = num_epochs or cfg.noncoherent_epochs
    if len(samples) < e * s:
        raise ValueError(f"need at least {e} epochs of samples")
    epochs = jnp.asarray(samples[: e * s].reshape(e, s), dtype=jnp.complex64)
    bins = np.asarray(cfg.doppler_bins_hz, dtype=np.float32)
    rot = doppler_rotations(jnp.asarray(bins), s, plan.sample_rate_hz)
    co = cfg.coherent_epochs
    dft = None
    if cfg.use_matmul_dft:
        # no-FFT build: twiddle tables generated on device, codes shipped
        # bit-packed (8 KB), code spectrum as a matmul
        dft = dft_tables_device(s)
        packed = jnp.asarray(pack_code_bits(prns, plan))
        cfc = code_spectrum_conj_matmul(unpack_code_table(packed, s), *dft)
    else:
        cfc = code_fft_conj(prns, plan)
    prec = dft_precision_enum(cfg)
    n_hyp = max(1, int(cfg.edge_hypotheses))
    # ONE fused device program: power cube -> hypothesis max-combine ->
    # hint mask -> peak analysis, returning only (P,) vectors.  The
    # (P, D, S) cube is never a program OUTPUT, which keeps device
    # memory traffic minimal (XLA fuses the mask into the reduction).
    keep = _hint_mask(prns, bins, doppler_hints_hz, cfg)
    keep_d = None if keep is None else jnp.asarray(keep)
    out = _acquire_fused(epochs, cfc, rot, jnp.asarray(bins), keep_d,
                         dft, coherent=co, n_hyp=n_hyp,
                         dft_precision=prec,
                         excl=exclusion_lags(cfg, plan))
    return _results_from_vectors(
        [np.asarray(v) for v in out], prns, plan, cfg)


@functools.partial(
    jax.jit,
    static_argnames=("coherent", "n_hyp", "dft_precision", "excl"))
def _acquire_fused(epochs, cfc, rot, bins, keep, dft,
                   coherent: int, n_hyp: int, dft_precision, excl: int):
    """Cube -> hypothesis max-combine -> hint mask -> peak analysis in
    one program (see acquire(); bit-edge hypotheses shift the coherent
    block grid and max-combine per-block-normalized powers, so one
    hypothesis has every block free of a nav-bit sign flip)."""
    if n_hyp == 1:
        power = acquisition_power(epochs, cfc, rot, coherent=coherent,
                                  dft=dft, dft_precision=dft_precision)
    else:
        power = acquisition_power_hypotheses(
            epochs, cfc, rot, coherent=coherent, n_hyp=n_hyp, dft=dft,
            dft_precision=dft_precision)
    if keep is not None:
        power = power * keep[:, :, None]
    return analyze_power_device(power, bins, excl)


def apply_doppler_hints(power, prns, bins, doppler_hints_hz, cfg):
    """Confine hinted PRNs' power cubes to hint +/- one Doppler bin.

    The capability of the firmware's user-supplied hints that skip the
    frequency search entirely (main.c:59-73, acquisition.c:72-79).
    Shared by acquire() and the mesh-sharded acquire_sharded().
    """
    # (P, D) keep-mask is built host-side (tiny) and applied as one
    # device multiply, so a device-resident cube stays on device
    keep = _hint_mask(prns, bins, doppler_hints_hz, cfg)
    if keep is None:
        return power
    if isinstance(power, np.ndarray):
        return power * keep[:, :, None]
    return power * jnp.asarray(keep)[:, :, None]


def refine_doppler(
    samples: np.ndarray,
    prn: int,
    code_phase_chips: float,
    coarse_doppler_hz: float,
    plan: SignalPlan = BASEBAND_PLAN,
    num_epochs: int = 32,
) -> float:
    """Fine Doppler via a long coherent FFT over per-epoch prompt
    correlations at the acquired code phase.

    The coarse grid (500 Hz bins + parabolic interpolation) leaves tens
    of Hz of error; the FFT of ``num_epochs`` consecutive 1 ms prompt
    outputs resolves the residual to ~1000/num_epochs Hz (zero-padded to
    8x for sub-bin interpolation).  The firmware has no counterpart —
    its pre-track only refines the code phase and leaves the carrier to
    the FLL pull-in (tracking.c:398-499).
    """
    from ..ops.replica import sample_replicas
    from ..ops.wipeoff import carrier_wipeoff

    from ..signal.ca_code import ca_table_bipolar

    s = plan.samples_per_epoch
    e = min(num_epochs, len(samples) // s)
    epochs = jnp.asarray(samples[: e * s].reshape(e, s), jnp.complex64)
    # prompt replica, code rate carrier-aided so the replica does not
    # walk off the signal over long spans (code Doppler = carrier
    # Doppler / 1540: ~0.8 chips/s at 1.2 kHz)
    code_rate = jnp.float32(
        plan.chips_per_sample * (1.0 + coarse_doppler_hz / FREQ_L1_HZ)
    )
    chips_per_epoch = float(code_rate) * s

    def per_epoch(carry, x):
        phase, cp = carry
        reps = sample_replicas(
            jnp.asarray(ca_table_bipolar([prn])),
            cp[None], code_rate[None], s, (0.0,),
        )[0, 0]
        y, phase = carrier_wipeoff(
            x, jnp.asarray([coarse_doppler_hz], jnp.float32), phase,
            plan.sample_rate_hz,
        )
        return (phase, jnp.mod(cp + chips_per_epoch,
                               jnp.float32(1023.0))), jnp.sum(y[0] * reps)

    _, prompts = jax.lax.scan(
        per_epoch,
        (jnp.zeros((1,), jnp.float32),
         jnp.float32(code_phase_chips)),
        epochs,
    )
    # squaring strips the BPSK nav bits; the squared tone sits at 2*df
    pad = 8 * e
    spec = np.abs(np.asarray(jnp.fft.fft(prompts * prompts, n=pad)))
    freqs = np.fft.fftfreq(pad, d=s / plan.sample_rate_hz)
    k = int(np.argmax(spec))
    df = freqs[k] / 2.0
    return float(coarse_doppler_hz + df)


@functools.partial(jax.jit, static_argnames=("plan",))
def refine_doppler_device(
    epochs: jnp.ndarray,            # (E, S) complex epochs, ON device
    code_table: jnp.ndarray,        # (C, 1023) bipolar codes
    code_phase_chips: jnp.ndarray,  # (C,) code phase at epochs[0]
    doppler_hz: jnp.ndarray,        # (C,) coarse Doppler
    plan: SignalPlan = BASEBAND_PLAN,
) -> jnp.ndarray:
    """Batched, fully device-resident :func:`refine_doppler`.

    Same math (code-rate-aided prompt replica scan, squared-prompt FFT
    with 8x zero-padding, argmax), vectorized over channels with every
    stage on device — only the (C,) refined-Doppler vector comes back.
    This is what keeps the weak-signal re-anchor inside the digest
    budget: the per-channel host version pulls E prompt values per
    channel; this one pulls 4 bytes.
    """
    from ..ops.replica import sample_replicas
    from ..ops.wipeoff import carrier_wipeoff

    e, s = epochs.shape
    doppler_hz = doppler_hz.astype(jnp.float32)
    code_rate = (
        jnp.float32(plan.chips_per_sample)
        * (1.0 + doppler_hz / jnp.float32(FREQ_L1_HZ))
    )                                               # (C,)
    chips_per_epoch = code_rate * s

    def per_epoch(carry, x):
        phase, cp = carry
        reps = sample_replicas(code_table, cp, code_rate, s, (0.0,))[:, 0]
        y, phase = carrier_wipeoff(x, doppler_hz, phase,
                                   plan.sample_rate_hz)
        prompts = jnp.sum(y * reps, axis=-1)        # (C,)
        return (phase, jnp.mod(cp + chips_per_epoch,
                               jnp.float32(1023.0))), prompts

    (_, _), prompts = jax.lax.scan(
        per_epoch,
        (jnp.zeros_like(doppler_hz),
         code_phase_chips.astype(jnp.float32)),
        epochs,
    )                                               # prompts (E, C)
    # squaring strips the BPSK nav bits; the squared tone sits at 2*df
    pad = 8 * e
    spec = jnp.abs(jnp.fft.fft(prompts * prompts, n=pad, axis=0))
    freqs = jnp.fft.fftfreq(pad, d=s / plan.sample_rate_hz)
    k = jnp.argmax(spec, axis=0)
    return doppler_hz + freqs[k].astype(jnp.float32) / 2.0


def acquire_epoch_vote(
    samples: np.ndarray,
    prns,
    plan: SignalPlan = BASEBAND_PLAN,
    cfg: AcqConfig = AcqConfig(),
    num_epochs: int | None = None,
) -> list:
    """Firmware-compatible epoch-voting detector.

    Per epoch, take the argmax lag of each (PRN, Doppler) row; vote into a
    histogram over lags; accept when max/avg over non-zero cells exceeds
    ``cfg.hist_ratio`` — the acceptance rule of acquisition.c:249-274 with
    the serial scan replaced by the FFT cube.
    """
    s = plan.samples_per_epoch
    e = num_epochs or cfg.noncoherent_epochs
    epochs = jnp.asarray(samples[: e * s].reshape(e, s), dtype=jnp.complex64)
    cfc = code_fft_conj(prns, plan)
    bins = np.asarray(cfg.doppler_bins_hz, dtype=np.float32)
    rot = doppler_rotations(jnp.asarray(bins), s, plan.sample_rate_hz)

    def per_epoch(x):
        xd = x[None, :] * rot
        corr = fft_circular_correlate(xd, cfc)      # (D, P, S)
        pw = noncoherent_power(corr)
        return pw.max(axis=(0, 2)), pw.argmax(axis=2).T, pw.max(axis=2).T

    _, argmaxes, maxes = jax.lax.map(per_epoch, epochs)
    argmaxes = np.asarray(argmaxes)                  # (E, P, D)
    maxes = np.asarray(maxes)                        # (E, P, D)

    results = []
    hist_step = max(1, int(round(plan.samples_per_chip * 0.5)))  # half chip
    for pi, prn in enumerate(prns):
        votes: dict = {}
        for ei in range(argmaxes.shape[0]):
            di = int(np.argmax(maxes[ei, pi]))
            cell = int(argmaxes[ei, pi, di]) // hist_step
            votes[(di, cell)] = votes.get((di, cell), 0) + 1
        (best_key, best_votes) = max(votes.items(), key=lambda kv: kv[1])
        nz = list(votes.values())
        avg = float(np.mean(nz))
        ratio = best_votes / max(avg, 1e-9)
        unique = len(nz)
        detected = (ratio > cfg.hist_ratio) or (
            unique == 1 and best_votes > cfg.freq_hist_min_votes
        )
        di, cell = best_key
        lag = cell * hist_step
        results.append(
            AcqResult(
                prn=int(prn),
                detected=bool(detected),
                doppler_hz=float(bins[di]),
                code_phase_chips=float(lag_to_code_phase(lag, plan) % 1023.0),
                peak_power=float(maxes[:, pi, di].mean()),
                peak_ratio=float(ratio),
                peak_to_mean=float(ratio),
            )
        )
    return results
