"""Shared helpers for the firmware-parity harnesses.

Bit-stream comparison contract (test_master_parity, test_parity_stress):
both pipelines emit PRE-polarity nav bits (raw prompt-sign majority), so
the streams agree up to

* a global 0/180 inversion per channel (the Costas ambiguity — each
  pipeline's PLL lands on its own phase);
* a few long inversion SEGMENTS at low C/N0: a Costas half-slip in
  either pipeline inverts its raw stream until the next slip.  The
  firmware's own polarity machinery re-detects and corrects this for
  its decoder (nav_data.c:285-305) — on the raw convention it shows as
  a segment boundary, not an error;
* single junk bits at segment/grid transitions: the one bit SPANNING a
  re-anchor or slip event votes a window split across two regimes.

Within every segment the values must agree exactly — that is the
bit-exactness claim.  The segment/junk budgets are tight enough that a
real demodulation divergence (independent bit errors) fails: even a
0.5% random error rate over 700 bits yields ~3 expected junk runs AND
breaks the segment count.
"""

import numpy as np


def match_bits(fw_bits, fw_times, ours_bits_list, max_offset=9):
    """Pair each firmware bit with its majority-overlap JAX bit.

    The firmware's extraction grid wobbles a few epochs around noise
    re-anchors (every on-grid flip rebases old_swap_time,
    nav_data.c:105-129).  A fw bit at offset |d| <= 9 still overlaps
    its nearest JAX bit by >= 11 of 20 epochs, so that bit carries the
    same transmitted bit.  Returns (xor_stream, times, unmatched)."""
    fb = np.asarray(fw_bits)
    fs = np.asarray(fw_times)
    tt = np.asarray([t for t, _ in ours_bits_list])
    tb = np.asarray([v for _, v in ours_bits_list])
    xs, ts = [], []
    unmatched = 0
    for v, s in zip(fb, fs):
        j = int(np.argmin(np.abs(tt - s)))
        if abs(int(tt[j]) - int(s)) > max_offset:
            unmatched += 1
            continue
        xs.append(int(v) ^ int(tb[j]))
        ts.append(int(s))
    return np.asarray(xs, np.int64), np.asarray(ts, np.int64), unmatched


def xor_runs(xs):
    """Run-length encode the XOR stream: [(value, length), ...]."""
    if len(xs) == 0:
        return []
    runs = []
    start = 0
    for i in range(1, len(xs)):
        if xs[i] != xs[start]:
            runs.append((int(xs[start]), i - start))
            start = i
    runs.append((int(xs[start]), len(xs) - start))
    return runs


def assert_bits_piecewise(tag, prn, fw_ch, ours_bits, min_matched=150):
    """Assert the two pipelines' bit streams are identical up to the
    module-docstring contract (global/segment inversions + junk bits at
    transitions)."""
    xs, _, unmatched = match_bits(
        fw_ch["bits"], fw_ch["bit_times"], ours_bits[prn])
    n = len(xs)
    assert n >= min(min_matched, int(0.8 * max(len(fw_ch["bits"]), 1))), (
        tag, prn, n)
    assert unmatched <= max(2, 0.02 * max(len(fw_ch["bits"]), 1)), (
        tag, prn, unmatched)
    runs = xor_runs(xs)
    segments = [r for r in runs if r[1] >= 3]
    junk = sum(r[1] for r in runs if r[1] < 3)
    assert len(segments) <= 5, (tag, prn, runs[:20])
    assert junk <= max(5, 0.01 * n), (tag, prn, junk, runs[:20])
