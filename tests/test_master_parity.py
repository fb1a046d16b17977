"""Observable-level + cold-start firmware parity (VERDICT r3 items 3-5).

``native/firmware_rx.cpp fw_master_run`` is the COMPLETE multi-channel
firmware pipeline: cold frequency search (acquisition.c:280-416,
hint-free), staged code search, TDM tracking, accurate swap-time
refinement (nav_data.c:145-218), the subframe-time ledger with the
ZERO-moment latch, and relative pseudoranges
(gps_master.c:159-329).  The JAX pipeline runs the SAME wire-format
capture cold (no Doppler hints) and must agree with the firmware
pipeline on:

* the found frequency bin per PRN (within one 500 Hz bin — the grid
  quantization) — the firmware's hardest cold-start stage;
* the nav-bit streams, bit-exactly on the shared 20 ms grid;
* the single-differenced relative pseudoranges (both pipelines pin the
  reference satellite's range to the 68.802 ms convention; differencing
  against the reference removes each pipeline's common-mode
  conditioner/correlator group delay): integer-light-ms agreement up
  to the firmware's OWN swap-time dither (exactly +/-1 ms excursions,
  nav_data.c:145-218 resolution), window means within 55 m, overlap
  mean within 40 m (see test_relative_pseudorange_parity for the
  error budget and the dither signature).

Both pipelines run their code filters (ENABLE_CODE_FILTER=1 is the
firmware's production default, config.h:36): the firmware averages
~1 s windows (timestamped at window center, the same compensation it
applies to tow_s), the JAX receiver runs its drift-detrended filter.
Filtering takes the DLL jitter out of the comparison so the bound
tests the LEDGER math (boundary times, wrap handling, reference
convention), not loop noise.

Nav bits compare bit-exactly on the raw (pre-polarity) convention:
the oracle undoes its inv_polarity_flag at emission, so the firmware's
mid-run polarity discovery (nav_data.c:285-305) cannot flip the
stream relative to the JAX scan's pre-polarity bits.
"""

import json
import pathlib
import subprocess

import numpy as np
import pytest

from stm32f4_sdr_gps_tpu.config import CLIGHT, ReceiverConfig, TrackConfig
from stm32f4_sdr_gps_tpu.pvt.observables import (ChannelObservables,
                                                 form_observations)
from stm32f4_sdr_gps_tpu.runtime import native
from stm32f4_sdr_gps_tpu.runtime.receiver import Receiver
from stm32f4_sdr_gps_tpu.signal.capture import reference_to_baseband

NATIVE_DIR = pathlib.Path(__file__).resolve().parent.parent / "native"
# 38 s: the firmware pipeline's ledger only starts once EVERY channel
# delivered a first subframe (ZERO latch) — cold polarity discovery
# (two inverted preambles ~ 12 s) puts that at ~25 s, so the overlap
# window the pseudorange comparison feeds on is the tail
DURATION_MS = 38000
PRNS = (2, 7, 15, 24)      # capture_gen's constellation shell


@pytest.fixture(scope="module")
def cold_pipelines(tmp_path_factory):
    if native.get_lib() is None:
        pytest.skip("native toolchain unavailable")
    tmp = tmp_path_factory.mktemp("coldparity")
    cap = tmp / "cap.bin"
    truth_p = tmp / "truth.json"
    subprocess.run(["make", "-s", "-C", str(NATIVE_DIR), "capture_gen"],
                   check=True)
    subprocess.run(
        [str(NATIVE_DIR / "capture_gen"), "--out", str(cap),
         "--truth", str(truth_p), "--cib", "20",
         "--duration-ms", str(DURATION_MS), "--cn0", "47", "--seed", "3"],
        check=True, capture_output=True)
    words = np.fromfile(cap, dtype=np.uint16)
    truth = json.loads(truth_p.read_text())

    # firmware pipeline, fully cold (hints all 0 = cold frequency search)
    fw = native.firmware_master_run(words, list(PRNS))

    # JAX pipeline, fully cold (no doppler hints), code filter off
    bb = np.asarray(reference_to_baseband(native.unpack_bits16(words)))
    cfg = ReceiverConfig(
        prns=PRNS,
        track=TrackConfig(pll_bad_state_threshold=10**9),
        enable_position=False,
        track_block_epochs=500,
    )
    rx = Receiver(cfg)
    ours_bits = {p: [] for p in PRNS}
    orig = rx._push_channel_bit

    def bit_hook(ch, value, epoch):
        ours_bits[ch.prn].append((int(epoch), int(value)))
        return orig(ch, value, epoch)

    rx._push_channel_bit = bit_hook
    # observable capture at every block end once all channels hold a
    # subframe boundary (form_observations: the production path)
    ours_obs = []     # (epoch_ms, {prn: P_m})

    def status_cb(r):
        ready = [c for c in r.channels if c.subframe_time_ms > 0]
        if len(ready) < len(PRNS):
            return
        chobs = [ChannelObservables(
            prn=c.prn, subframe_time_ms=c.subframe_time_ms,
            tow_s=c.subframe_tow_s, week=c.eph.week or 2290,
            code_phase_chips=c.code_phase_chips,
            doppler_hz=c.doppler_hz, snr_db=c.snr_db)
            for c in ready]
        epoch = r.epoch_cursor - 1
        obs = form_observations(chobs, epoch)
        if obs:
            ours_obs.append((epoch, {o.sat: o.P for o in obs}))

    report = rx.run(bb, status_callback=status_cb)
    ours = {ch.prn: ch for ch in report.channels}
    return fw, ours_bits, ours, ours_obs, truth


def test_cold_frequency_search_parity(cold_pipelines):
    """The firmware's cold frequency search (hint-free) and the JAX
    acquisition land on the same 500 Hz bin (+/- one bin of grid
    quantization at bin-edge Dopplers) for every PRN."""
    fw, _, ours, _, truth = cold_pipelines
    by_prn = {s["prn"]: s for s in truth["sats"]}
    assert fw["tracking_count"] == len(PRNS)
    for chd in fw["channels"]:
        prn = chd["prn"]
        assert chd["found_freq_hz"] > -100000, (prn, "freq search failed")
        true_dop = by_prn[prn]["doppler_hz"]
        assert abs(chd["found_freq_hz"] - true_dop) <= 500.0, (
            prn, chd["found_freq_hz"], true_dop)
        # JAX cold acquisition agrees with the oracle's found bin
        ours_dop = ours[prn].acq.doppler_hz
        assert abs(ours_dop - chd["found_freq_hz"]) <= 500.0, (
            prn, ours_dop, chd["found_freq_hz"])


def test_cold_nav_bits_bit_exact(cold_pipelines):
    """Nav bits from the fully-cold firmware pipeline match the JAX
    pipeline bit-exactly up to the 0/180 slip-segment contract
    (tests/parity_util.py: global inversion, a few long slip segments,
    junk bits only at transitions)."""
    from parity_util import assert_bits_piecewise

    fw, ours_bits, _, _, _ = cold_pipelines
    for chd in fw["channels"]:
        assert_bits_piecewise(
            "cold", chd["prn"], chd, ours_bits, min_matched=300)


def test_relative_pseudorange_parity(cold_pipelines):
    """Single-differenced relative pseudoranges agree between the
    pipelines, with ZERO integer-millisecond disagreements.

    Error budget: both pipelines carry independent DLL noise whose
    correlation time (~1 s, the DLL bandwidth) exceeds both code-filter
    windows, so per-epoch single differences still jitter ~30 m rms
    even filtered — per-epoch the bound is a ~4.5-sigma gate (160 m,
    still < 1/1800 of one integer millisecond), plus a per-channel DLL
    equilibrium bias of up to ~0.13 chip between the two correlator
    topologies.  The LEDGER agreement (boundary times, wrap handling,
    68.802 ms reference convention) is asserted where it is visible:
    2 s window means within 55 m, whole-overlap mean within 40 m, and
    the integer-light-ms class structure (the firmware's swap-time
    dither is EXACTLY +/-1 ms; anything else fails).  A ledger defect
    is a >=300 km (1 ms) or ~300 m (1 epoch at the bit grid) jump —
    far above every bound."""
    fw, _, _, ours_obs, _ = cold_pipelines
    assert len(ours_obs) >= 10, "JAX pipeline produced too few obs epochs"
    ft = np.asarray(fw["pr_times_ms"], np.float64)
    fpr = np.asarray(fw["pseudorange_m"])          # (n_ch, n_pr)
    assert fpr.shape[1] >= 10, "oracle produced too few pseudoranges"
    prn_order = [chd["prn"] for chd in fw["channels"]]
    light_ms = CLIGHT / 1000.0

    # steady-state region: skip the first second after the ledger
    # starts (the ZERO-latch epoch carries the firmware's own stale
    # max_subframe_cnt quirk, gps_master.c:224-225 ordering)
    t_ok = ft >= ft[0] + 1000.0
    fts = ft[t_ok]
    checked = 0
    ref = prn_order[0]
    errs = {prn: [] for prn in prn_order[1:]}      # (epoch, err)
    for i, prn in enumerate(prn_order):
        if prn == ref:
            continue
        d_fw = (fpr[i] - fpr[prn_order.index(ref)])[t_ok]
        # the fw ledger steps by whole light-ms at swap-time dither
        # boundaries (see below) — interpolating ACROSS a step would
        # manufacture mid-step garbage, so those intervals are skipped
        step_iv = [(fts[k], fts[k + 1])
                   for k in np.nonzero(
                       np.abs(np.diff(d_fw)) > 0.5 * light_ms)[0]]
        for epoch, pmap in ours_obs:
            if epoch < ft[0] + 1200.0 or epoch > fts[-1]:
                continue
            if any(a < epoch < b for a, b in step_iv):
                continue
            errs[prn].append(
                (float(epoch), float(pmap[prn] - pmap[ref])
                 - float(np.interp(epoch, fts, d_fw))))
            checked += 1
    assert checked >= 20, f"too few comparable epochs ({checked})"
    worst = 0.0
    for prn, rows in errs.items():
        e = np.asarray([r[1] for r in rows])
        t = np.asarray([r[0] for r in rows])
        assert len(e) >= 6, (prn, len(e))
        # Split by integer light-ms class.  The firmware's swap-time
        # refinement has 1-EPOCH resolution and its estimate dithers
        # when a bit edge sits near a correlation-window boundary
        # (nav_data.c:145-218 swap_pos; observed as accurate_swap_time
        # flapping 6<->7 on PRN 24 in this very capture) — each flap
        # shifts that channel's fw pseudorange by EXACTLY one light-ms
        # for one subframe interval.  The JAX ledger (median dejitter,
        # runtime.receiver.dejitter_boundary) does not carry the quirk,
        # so the parity contract is: every excursion is exactly +/-1
        # light-ms (the firmware's own quantization, never anything
        # else), the 0 class is substantially present, and the sub-ms
        # residual agrees everywhere.
        ms_class = np.round(e / light_ms)
        sub_ms = e - ms_class * light_ms
        vals, cnts = np.unique(ms_class, return_counts=True)
        assert set(vals.tolist()) <= {-1.0, 0.0, 1.0}, (prn, vals)
        # the 0 class must be substantially present — a CONSTANT +/-1
        # class would be a real convention bug, not the dither
        frac0 = (cnts[vals == 0].sum() / len(e)) if 0 in vals else 0.0
        assert frac0 >= 0.25, (prn, dict(zip(vals.tolist(),
                                             cnts.tolist())))
        worst = max(worst, float(np.abs(sub_ms).max()))
        # sub-ms agreement holds through ledger excursions too
        # (~4.5 sigma of the correlated DLL jitter) — a single receiver
        # dejitter slip would land at >= 300 m (one epoch) and fail
        assert np.abs(sub_ms).max() < 160.0, (prn, np.abs(sub_ms).max())
        sel0 = ms_class == 0
        e0, t0 = e[sel0], t[sel0]
        # whole-overlap mean: the ledger/convention agreement.  Budget:
        # per-channel DLL equilibria differ up to ~0.13 chip (~40 m)
        # between the two correlator topologies (1-bit odd-offset E/L
        # vs float E/P/L — the same budget the stress trajectory test
        # pins at < 0.32 chip); ledger defects are 300 m (one epoch) or
        # 300 km (one ms) quanta, far above both bounds
        assert abs(e0.mean()) < 40.0, (prn, e0.mean())
        # 2 s window means: localized ledger slips can't hide in the
        # global mean
        for w0 in np.arange(t0[0], t0[-1], 2000.0):
            sel = (t0 >= w0) & (t0 < w0 + 2000.0)
            if sel.sum() >= 2:
                assert abs(e0[sel].mean()) < 55.0, (prn, w0, e0[sel].mean())
    print(f"pseudorange parity: {checked} single-differences, "
          f"worst sub-ms |delta| = {worst:.2f} m")
