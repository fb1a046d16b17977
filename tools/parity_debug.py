"""Diagnostic for the master-parity / parity-stress harnesses.

Runs the same two pipelines tests/test_master_parity.py runs, but caches
every expensive stage in /tmp/parity_cache so the ANALYSIS can iterate in
seconds.  Prints per-channel bit agreement with polarity-segment
analysis and the single-difference pseudorange residual statistics.

Usage: python tools/parity_debug.py [--refresh] [--stress CN0]
"""

import json
import os
import pathlib
import pickle
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from stm32f4_sdr_gps_tpu.config import (CLIGHT, ReceiverConfig,  # noqa: E402
                                        TrackConfig)
from stm32f4_sdr_gps_tpu.pvt.observables import (ChannelObservables,  # noqa: E402
                                                 form_observations)
from stm32f4_sdr_gps_tpu.runtime import native  # noqa: E402
from stm32f4_sdr_gps_tpu.runtime.receiver import Receiver  # noqa: E402
from stm32f4_sdr_gps_tpu.signal.capture import reference_to_baseband  # noqa: E402

NATIVE_DIR = pathlib.Path(__file__).resolve().parent.parent / "native"
CACHE = pathlib.Path("/tmp/parity_cache")
CACHE.mkdir(exist_ok=True)
DURATION_MS = 38000
PRNS = (2, 7, 15, 24)


def gen_capture(tag, cn0, seed, dur, extra=()):
    cap = CACHE / f"cap_{tag}.bin"
    truth_p = CACHE / f"truth_{tag}.json"
    if not cap.exists():
        subprocess.run(["make", "-s", "-C", str(NATIVE_DIR), "capture_gen"],
                       check=True)
        subprocess.run(
            [str(NATIVE_DIR / "capture_gen"), "--out", str(cap),
             "--truth", str(truth_p), "--cib", "20",
             "--duration-ms", str(dur), "--cn0", str(cn0),
             "--seed", str(seed)] + list(extra),
            check=True, capture_output=True)
    words = np.fromfile(cap, dtype=np.uint16)
    truth = json.loads(truth_p.read_text())
    return words, truth


def fw_master(tag, words):
    p = CACHE / f"fw_{tag}.pkl"
    if p.exists():
        return pickle.loads(p.read_bytes())
    fw = native.firmware_master_run(words, list(PRNS))
    p.write_bytes(pickle.dumps(fw))
    return fw


def our_master(tag, words):
    p = CACHE / f"ours_{tag}.pkl"
    if p.exists():
        return pickle.loads(p.read_bytes())
    bb = np.asarray(reference_to_baseband(native.unpack_bits16(words)))
    cfg = ReceiverConfig(
        prns=PRNS,
        track=TrackConfig(pll_bad_state_threshold=10**9),
        enable_position=False,
        track_block_epochs=500,
    )
    rx = Receiver(cfg)
    ours_bits = {p_: [] for p_ in PRNS}
    orig = rx._push_channel_bit

    def bit_hook(ch, value, epoch):
        ours_bits[ch.prn].append((int(epoch), int(value)))
        return orig(ch, value, epoch)

    rx._push_channel_bit = bit_hook
    ours_obs = []

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
    out = dict(
        bits=ours_bits, obs=ours_obs,
        acq_dop={ch.prn: ch.acq.doppler_hz for ch in report.channels},
    )
    p.write_bytes(pickle.dumps(out))
    return out


def bit_analysis(fw, ours_bits):
    print("==== nav bits ====")
    for chd in fw["channels"]:
        prn = chd["prn"]
        fb = np.asarray(chd["bits"])
        fs = np.asarray(chd["bit_times"])
        tt = np.asarray([t for t, _ in ours_bits[prn]])
        tb = np.asarray([v for _, v in ours_bits[prn]])
        xs, times = [], []
        unmatched = 0
        for v, s in zip(fb, fs):
            js = np.nonzero(np.abs(tt - s) <= 1)[0]
            if len(js) == 0:
                unmatched += 1
                continue
            xs.append(int(v ^ tb[js[0]]))
            times.append(int(s))
        xs = np.asarray(xs)
        times = np.asarray(times)
        # polarity segments: count switch points in the XOR stream
        sw = np.nonzero(np.diff(xs) != 0)[0]
        print(f"PRN {prn}: fw_bits={len(fb)} matched={len(xs)} "
              f"unmatched={unmatched} mismatch={xs.sum()} "
              f"switch_points={len(sw)}")
        if len(sw) and len(sw) < 20:
            print(f"   switch bit-times: {[int(times[i+1]) for i in sw]}")
        if len(sw) >= 20:
            print(f"   first 10 switches: "
                  f"{[int(times[i+1]) for i in sw[:10]]}")


def pr_analysis(fw, ours_obs):
    print("==== relative pseudoranges ====")
    ft = np.asarray(fw["pr_times_ms"], np.float64)
    fpr = np.asarray(fw["pseudorange_m"])
    prn_order = [chd["prn"] for chd in fw["channels"]]
    if len(ft) == 0:
        print("no fw pseudoranges!")
        return
    print(f"fw series: {len(ft)} points, t=[{ft[0]:.0f},{ft[-1]:.0f}]")
    print(f"ours obs epochs: {len(ours_obs)}; "
          f"range {ours_obs[0][0] if ours_obs else '-'}"
          f"..{ours_obs[-1][0] if ours_obs else '-'}")
    t_ok = ft >= ft[0] + 1000.0
    errs = {prn: [] for prn in prn_order[1:]}
    for epoch, pmap in ours_obs:
        if epoch < ft[0] + 1200.0 or epoch > ft[-1]:
            continue
        fw_p = {prn: np.interp(epoch, ft[t_ok], fpr[i][t_ok])
                for i, prn in enumerate(prn_order)}
        ref = prn_order[0]
        for prn in prn_order[1:]:
            d_fw = fw_p[prn] - fw_p[ref]
            d_ours = pmap[prn] - pmap[ref]
            errs[prn].append((epoch, d_ours - d_fw))
    for prn, rows in errs.items():
        if not rows:
            print(f"PRN {prn}: no comparable epochs")
            continue
        e = np.asarray([r[1] for r in rows])
        t = np.asarray([r[0] for r in rows])
        drift = np.polyfit(t, e, 1)[0] * 1000.0 if len(e) > 3 else 0.0
        print(f"PRN {prn}-{prn_order[0]}: n={len(e)} mean={e.mean():+.2f} "
              f"std={e.std():.2f} max|.|={np.abs(e).max():.2f} m "
              f"drift={drift:+.3f} m/s")
        wins = []
        for w0 in np.arange(t[0], t[-1], 2000.0):
            sel = (t >= w0) & (t < w0 + 2000.0)
            if sel.sum() >= 2:
                wins.append(round(float(e[sel].mean()), 1))
        print(f"   2s-window means: {wins}")


def main():
    if "--refresh" in sys.argv:
        for f in CACHE.iterdir():
            f.unlink()
    tag = "cold47s3"
    words, truth = gen_capture(tag, 47, 3, DURATION_MS)
    fw = fw_master(tag, words)
    print(f"fw tracking_count={fw['tracking_count']}")
    for chd in fw["channels"]:
        print(f"PRN {chd['prn']}: freq={chd['found_freq_hz']} "
              f"track_ms={chd['track_start_ms']} sync={chd['sync_ms']} "
              f"subframes={chd['subframes']} bits={len(chd['bits'])}")
    ours = our_master(tag, words)
    bit_analysis(fw, ours["bits"])
    pr_analysis(fw, ours["obs"])


if __name__ == "__main__":
    main()
