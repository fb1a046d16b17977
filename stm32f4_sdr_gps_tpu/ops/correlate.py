"""Correlation primitives: FFT circular correlation and the E/P/L bank.

These are the batched descendants of the firmware's bit-twiddled MAC
loop (``gps_mult_and_summ``, gps_misc.c:48-93) and serial lag scan
(``correlation_search``, gps_misc.c:155-191):

* acquisition evaluates *all* code lags of an epoch at once via
  ``IFFT(FFT(x) . conj(FFT(c)))`` — O(S log S) per (PRN, Doppler) instead
  of the firmware's 2046 serial correlations (~0.2 s/bin on the MCU,
  acquisition.c:279);
* tracking evaluates the three E/P/L lags for all channels as one fused
  multiply-reduce (gps_correlation_iq x3, tracking.c:136-138).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import CODE_LENGTH, CODE_RATE_HZ, SignalPlan
from ..signal.ca_code import ca_code_bits


def sampled_code_table(prns, plan: SignalPlan, dtype=np.float32) -> np.ndarray:
    """(P, S) bipolar codes sampled at the plan rate with zero code phase."""
    s = plan.samples_per_epoch
    idx = (
        np.floor(np.arange(s) * (CODE_RATE_HZ / plan.sample_rate_hz))
        .astype(np.int64) % CODE_LENGTH
    )
    rows = []
    for prn in prns:
        bits = ca_code_bits(prn)[idx]
        rows.append((1 - 2 * bits.astype(np.int32)).astype(dtype))
    return np.stack(rows)


def code_fft_conj(prns, plan: SignalPlan) -> jnp.ndarray:
    """conj(FFT) of the sampled codes, precomputed once per PRN set."""
    table = sampled_code_table(prns, plan)
    return jnp.conj(jnp.fft.fft(jnp.asarray(table), axis=-1))


def fft_circular_correlate(
    x: jnp.ndarray,             # (..., S) complex epochs
    cfc: jnp.ndarray,           # (P, S) conj code FFTs
) -> jnp.ndarray:
    """Circular correlation of x against every PRN: (..., P, S) complex.

    Lag convention: ``corr[..., p, m] = sum_k x[k] * c[(k - m) % S]`` (c is
    real).  For a signal whose code phase at sample 0 is ``phi`` chips, the
    peak lands at ``m = (S - phi / chips_per_sample) % S``; use
    ``lag_to_code_phase`` to convert.
    """
    X = jnp.fft.fft(x, axis=-1)
    return jnp.fft.ifft(X[..., None, :] * cfc, axis=-1)


def pack_code_bits(prns, plan: SignalPlan) -> np.ndarray:
    """(P, ceil(S/8)) uint8 — sampled C/A code chips, bit-packed.

    A compact form of ``sampled_code_table`` (8 KB for 32 PRNs vs
    262 KB f32); ``unpack_code_table`` rebuilds the bipolar table on
    device."""
    table = sampled_code_table(prns, plan)
    return np.packbits((table < 0).astype(np.uint8), axis=-1)


@functools.partial(jax.jit, static_argnames=("s",))
def unpack_code_table(packed: jnp.ndarray, s: int) -> jnp.ndarray:
    """(P, S) bipolar f32 code table from ``pack_code_bits``, on device."""
    shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)    # packbits is MSB-first
    bits = (packed[..., None] >> shifts) & jnp.uint8(1)
    bits = bits.reshape(packed.shape[0], -1)[:, :s]
    return 1.0 - 2.0 * bits.astype(jnp.float32)


@jax.jit
def code_spectrum_conj_matmul(table: jnp.ndarray, wc: jnp.ndarray,
                              ws: jnp.ndarray) -> jnp.ndarray:
    """conj(DFT(code)) built with the matmul DFT — no FFT HLO.

    For a real code row c: DFT(c) = c @ (wc - i*ws), so
    conj(DFT(c)) = c @ wc + i*(c @ ws).  With ``unpack_code_table``
    the whole matmul acquisition build stays on device."""
    return jax.lax.complex(
        jnp.matmul(table, wc, precision=jax.lax.Precision.HIGHEST),
        jnp.matmul(table, ws, precision=jax.lax.Precision.HIGHEST))


def dft_tables(n: int, dtype=np.float32) -> tuple[np.ndarray, np.ndarray]:
    """(cos, sin) of the length-n DFT twiddle matrix, as host arrays.

    ``W[j, k] = exp(-2i*pi*j*k/n) = cos - i*sin``.  W is symmetric and
    ``conj(W) = n * W^-1``, so ONE table pair serves both directions:
    forward ``X = x @ (cos - i*sin)``, inverse ``x = X @ (cos + i*sin)/n``.
    The phase index ``j*k`` is reduced mod n in exact integer arithmetic
    before the float conversion (j*k reaches ~4.2e6 at n=2046; naive
    float32 angles would lose ~2 digits).
    """
    j = np.arange(n, dtype=np.int64)
    m = np.outer(j, j) % n
    ang = (2.0 * np.pi / n) * m.astype(np.float64)
    return np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)


@functools.partial(jax.jit, static_argnames=("n",))
def dft_tables_device(n: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """``dft_tables`` computed ON the accelerator (cos/sin of an integer
    outer product mod n — exact in int32 up to n=46341).

    Host-built (S, S) tables are ~16.7 MB each; generating them on the
    device is cheaper than uploading them."""
    j = jnp.arange(n, dtype=jnp.int32)
    m = (j[:, None] * j[None, :]) % n
    ang = jnp.float32(2.0 * np.pi / n) * m.astype(jnp.float32)
    return jnp.cos(ang), jnp.sin(ang)


def matmul_circular_correlate(
    x: jnp.ndarray,             # (..., S) complex epochs
    cfc: jnp.ndarray,           # (P, S) conj code FFTs
    wc: jnp.ndarray,            # (S, S) DFT cos table (dft_tables)
    ws: jnp.ndarray,            # (S, S) DFT sin table
    precision=jax.lax.Precision.HIGHEST,
) -> jnp.ndarray:
    """``fft_circular_correlate`` with matmul DFTs instead of FFT HLOs.

    Same contract and lag convention as ``fft_circular_correlate``; the
    transform runs as (B, S) @ (S, S) real matmuls on the tensor cores.
    S = 2046 is not a power of two (2*3*11*31), so an FFT of that
    length is a mixed-radix/Bluestein transform, while a dense S^2
    contraction is a plain matrix product (the matmul form of the
    acquisition redesign of acquisition.c:226-319's serial lag scan).
    ``precision=HIGHEST`` keeps f32 accuracy (~1e-5 relative vs the FFT
    path); DEFAULT lets the GPU round the inputs to TF32 (10-bit
    mantissa), ~1e-3 relative — fine for peak detection.  Which is
    faster on the card: not measured.
    """
    dot = functools.partial(jnp.matmul, precision=precision)
    xr = jnp.real(x).astype(jnp.float32)
    xi = jnp.imag(x).astype(jnp.float32)
    # forward: X = x @ (wc - i*ws)
    x_re = dot(xr, wc) + dot(xi, ws)
    x_im = dot(xi, wc) - dot(xr, ws)
    # spectrum product with conj code FFTs, new PRN axis
    cr = jnp.real(cfc).astype(jnp.float32)
    ci = jnp.imag(cfc).astype(jnp.float32)
    z_re = x_re[..., None, :] * cr - x_im[..., None, :] * ci
    z_im = x_re[..., None, :] * ci + x_im[..., None, :] * cr
    # inverse: corr = Z @ (wc + i*ws) / S
    inv = np.float32(1.0 / x.shape[-1])
    c_re = (dot(z_re, wc) - dot(z_im, ws)) * inv
    c_im = (dot(z_re, ws) + dot(z_im, wc)) * inv
    return jax.lax.complex(c_re, c_im)


#: Precision of the tracking and pre-track correlator contractions.  An
#: f32 contraction without one runs in TF32 on an H100 (10-bit mantissa
#: inputs), which rounds each 2046-sample correlation by ~1e-3 of its
#: magnitude; HIGHEST keeps f32, so the device loops follow the CPU
#: reference (chip_smoke.py phase 2 measures the agreement).
CORRELATOR_PRECISION = jax.lax.Precision.HIGHEST


def epl_correlate(
    y: jnp.ndarray,             # (C, n) baseband (carrier-wiped) signal
    replicas: jnp.ndarray,      # (C, L, n) sampled bipolar replicas
) -> jnp.ndarray:
    """(C, L) complex correlator outputs: sum_k y[c,k] * r[c,l,k].

    The bipolar replica is real so no conjugation is needed.  With the
    default lags (-0.5, 0, +0.5) chips the columns are (E, P, L), matching
    tracking.c:122-138.

    Implemented as two *real* contractions on y's components: a complex
    x real einsum scalarizes on the XLA CPU backend (~2.6x slower for
    the whole tracking scan); the real form is numerically identical.
    """
    reps = replicas.astype(jnp.float32)
    i_part = jnp.einsum("cn,cln->cl", jnp.real(y).astype(jnp.float32), reps,
                        precision=CORRELATOR_PRECISION)
    q_part = jnp.einsum("cn,cln->cl", jnp.imag(y).astype(jnp.float32), reps,
                        precision=CORRELATOR_PRECISION)
    return jax.lax.complex(i_part, q_part)


def lag_to_code_phase(lag_samples, plan: SignalPlan):
    """Convert an FFT-correlation peak lag (samples, possibly fractional)
    to the signal's code phase at sample 0, in chips [0, 1023)."""
    s = plan.samples_per_epoch
    return ((s - np.asarray(lag_samples)) % s) * plan.chips_per_sample


def noncoherent_power(corr: jnp.ndarray) -> jnp.ndarray:
    """|corr|^2 as float32 (acquisition non-coherent accumulation unit)."""
    return (corr.real**2 + corr.imag**2).astype(jnp.float32)
