"""End-to-end demo: simulate a 4-satellite sky, cold-start the receiver,
decode ephemerides, and print the position fix vs ground truth.

    python examples/full_fix_demo.py

Runs on JAX's default device (a GPU when one is present; set
JAX_PLATFORMS=cpu to run on the CPU).  On an H100 (400 W limit) the
whole receiver ran the same 29 s capture at 21.7x real time after
compilation (chip_smoke.py phase 3).
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from stm32f4_sdr_gps_tpu.config import ReceiverConfig
from stm32f4_sdr_gps_tpu.io.status import render_status
from stm32f4_sdr_gps_tpu.runtime.receiver import Receiver
from stm32f4_sdr_gps_tpu.signal.scenarios import fix_scenario


def main():
    print("synthesizing 29 s of 4-satellite IQ (2.046 MHz complex)...")
    t0 = time.time()
    sc = fix_scenario(num_epochs=29_000, cn0_dbhz=48.0)
    print(f"  done in {time.time() - t0:.1f} s "
          f"({len(sc.samples):,} samples)")

    rx = Receiver(ReceiverConfig(prns=sc.prns, track_block_epochs=1000))
    print("running the receiver (acquire -> track -> decode -> solve)...")
    t0 = time.time()
    report = rx.run(sc.samples)
    print(f"  done in {time.time() - t0:.1f} s "
          f"({report.epochs_processed / (time.time() - t0) / 1000:.1f}x "
          f"real time)\n")

    print(render_status(rx))
    if report.solutions:
        sol = report.solutions[-1]
        err = np.linalg.norm(sol.rr - sc.rr_true)
        print(f"\nposition error vs planted truth: {err:.1f} m "
              f"({sol.ns} satellites)")
    else:
        print("\nno fix obtained")


if __name__ == "__main__":
    main()
