"""Sustained streaming soak: native SPSC ring -> receiver, minutes long.

The system-level analogue of the firmware's double-buffer staleness
guard (signal_capture.c:107-123 drops a block if the ISR copy is >900 us
stale): a paced producer thread unpacks the 1-bit wire capture and
pushes sign samples into the native SPSC ring at ``--rate-x`` times
real time; the consumer loop pops whole-epoch chunks, conditions them
to baseband, and runs the stock Receiver.  A full ring means the
consumer fell behind the pace — the producer DROPS that chunk and
counts the epochs, exactly the overrun semantics of the firmware's
guard.  Success = zero dropped epochs at the requested pace over the
whole capture, with the decode/fix ledger intact.

Usage:
    python tools/soak.py [--capture-s 300] [--rate-x 1.0] [--cn0 48]
        [--block-epochs 500] [--ring-ms 2000] [--platform cpu|gpu]
Prints one JSON line: sustained x-real-time, dropped epochs, ring
high-water, fixes.  CPU by default; --platform gpu runs the same loop
on JAX's default GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

REPO = Path(__file__).resolve().parents[1]
NATIVE_DIR = REPO / "native"
WORDS_PER_EPOCH = 1023
SIGNS_PER_EPOCH = 16368


def log(m):
    print(f"[{time.strftime('%H:%M:%S')}] {m}", file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--capture-s", type=int, default=300)
    ap.add_argument("--rate-x", type=float, default=1.0)
    ap.add_argument("--cn0", type=float, default=48.0)
    ap.add_argument("--seed", type=int, default=9)
    ap.add_argument("--block-epochs", type=int, default=500)
    ap.add_argument("--ring-ms", type=int, default=2000)
    ap.add_argument("--platform", default="cpu", choices=("cpu", "gpu"))
    ap.add_argument("--state-dir",
                    default=os.path.join(tempfile.gettempdir(), "sdr_soak"))
    args = ap.parse_args()

    import jax

    if args.platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
    else:
        from stm32f4_sdr_gps_tpu.utils.device_info import require_gpu

        require_gpu(jax.devices())

    from stm32f4_sdr_gps_tpu.config import ReceiverConfig
    from stm32f4_sdr_gps_tpu.runtime import native
    from stm32f4_sdr_gps_tpu.runtime.native import NativeRing
    from stm32f4_sdr_gps_tpu.runtime.receiver import Receiver
    from stm32f4_sdr_gps_tpu.signal.capture import reference_to_baseband

    state = Path(args.state_dir)
    state.mkdir(parents=True, exist_ok=True)
    cap = state / f"cap_{args.capture_s}s_{args.cn0:.0f}_{args.seed}.bin"
    truth_p = cap.with_suffix(".truth.json")
    if not cap.exists():
        log(f"generating {args.capture_s}s wire capture (capture_gen)")
        subprocess.run(["make", "-s", "-C", str(NATIVE_DIR), "capture_gen"],
                       check=True)
        subprocess.run(
            [str(NATIVE_DIR / "capture_gen"), "--out", str(cap),
             "--truth", str(truth_p), "--cib", "20",
             "--duration-ms", str(args.capture_s * 1000),
             "--cn0", str(args.cn0), "--seed", str(args.seed),
             "--repeats", str(max(1, args.capture_s // 30))],
            check=True, capture_output=True)
    words = np.memmap(cap, dtype=np.uint16, mode="r")
    truth = json.loads(truth_p.read_text())
    total_epochs = len(words) // WORDS_PER_EPOCH
    log(f"capture: {total_epochs} epochs ({total_epochs/1000:.0f} s), "
        f"pacing at {args.rate_x}x real time")

    ring = NativeRing(args.ring_ms * SIGNS_PER_EPOCH)
    stats = {"pushed_epochs": 0, "dropped_epochs": 0, "ring_hw": 0,
             "producer_done": False}
    chunk_epochs = 100                      # 100 ms producer granularity
    chunk_period_s = chunk_epochs * 1e-3 / args.rate_x

    def producer(start_epoch: int):
        t_next = time.perf_counter()
        for e0 in range(start_epoch, total_epochs, chunk_epochs):
            n = min(chunk_epochs, total_epochs - e0)
            w = np.asarray(words[e0 * WORDS_PER_EPOCH:
                                 (e0 + n) * WORDS_PER_EPOCH])
            signs = native.unpack_bits16(w)
            # firmware staleness-guard semantics: a full ring means the
            # consumer is too far behind — drop THIS chunk, keep pacing
            if not ring.push(signs):
                stats["dropped_epochs"] += n
            else:
                stats["pushed_epochs"] += n
            stats["ring_hw"] = max(stats["ring_hw"], ring.available)
            t_next += chunk_period_s
            dt = t_next - time.perf_counter()
            if dt > 0:
                time.sleep(dt)
        stats["producer_done"] = True

    prns = tuple(s["prn"] for s in truth["sats"])
    rx = Receiver(ReceiverConfig(prns=prns,
                                 track_block_epochs=args.block_epochs))

    # cold start needs a contiguous prefix — feed it directly (the ring
    # stream starts after it), mirroring the firmware's acquisition on
    # the first buffered blocks.  The head also WARMS the exact
    # block-shape jit before pacing starts (a cold compile mid-stream
    # would overrun the ring through no fault of the steady-state path).
    spe = 2046
    block = args.block_epochs
    acq_e = rx.config.acq.noncoherent_epochs
    head_e = acq_e + block
    head = reference_to_baseband(native.unpack_bits16(
        np.asarray(words[: head_e * WORDS_PER_EPOCH])))
    rx.acquire_all(head)
    rx.start_tracking(head[acq_e * spe:], start_epoch=acq_e)
    rx.epoch_cursor = acq_e
    rx.process_block(head[acq_e * spe:])     # warms the block program
    consumed = head_e

    th = threading.Thread(target=producer, args=(consumed,), daemon=True)
    t0 = time.perf_counter()
    th.start()

    # consumer: drain FULL blocks only (every distinct block length is
    # its own XLA program; a mid-stream compile would stall the ring)
    stall_s = 0.0
    while consumed < total_epochs:
        need = min(block, total_epochs - consumed)
        while (ring.available < need * SIGNS_PER_EPOCH
               and not stats["producer_done"]):
            time.sleep(0.005)
            stall_s += 0.005
        avail_epochs = ring.available // SIGNS_PER_EPOCH
        n = min(need, avail_epochs)
        if n == 0:
            if stats["producer_done"]:
                break
            continue
        signs = ring.pop(n * SIGNS_PER_EPOCH)
        if signs is None:
            continue
        bb = reference_to_baseband(signs)
        rx.process_block(bb)
        consumed += n
    wall = time.perf_counter() - t0
    th.join(timeout=5)

    errs = []
    if rx.solutions:
        rr = np.asarray(truth["rr_ecef"])
        errs = [float(np.linalg.norm(s.rr - rr)) for s in rx.solutions]
    out = {
        "platform": args.platform,
        "capture_s": total_epochs / 1000.0,
        "rate_x": args.rate_x,
        "wall_s": round(wall, 1),
        "sustained_rt_x": round(consumed * 1e-3 / wall, 2),
        "consumed_epochs": consumed,
        "dropped_epochs": stats["dropped_epochs"],
        "ring_high_water_ms": round(stats["ring_hw"] / SIGNS_PER_EPOCH, 1),
        "ring_capacity_ms": args.ring_ms,
        "consumer_stall_s": round(stall_s, 1),
        "fixes": len(rx.solutions),
        "fix_error_m_last": round(errs[-1], 1) if errs else None,
        "channels_tracking": sum(
            1 for ch in rx.channels if ch.state_name == "TRACKING"),
    }
    print(json.dumps(out), flush=True)
    ok = stats["dropped_epochs"] == 0 and consumed >= total_epochs - 1000
    log("SOAK " + ("PASS" if ok else "FAIL"))
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
