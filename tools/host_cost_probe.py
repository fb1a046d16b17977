"""Measure the HOST side of the receiver loop vs channel count.

A device channel capacity is device-only; the per-channel host work —
the digest consumption loop, NavFramer bit pushes, subframe decode,
ChannelStatus bookkeeping (runtime.receiver._consume_digest) — scales
linearly with channels and bounds the SYSTEM.  This probe times exactly
that path with realistic digests: every channel streams a real LNAV
bitstream (preamble lock, parity, subframe decode all exercised), one
bit per codes_in_bit epochs, plus the fixed-cadence work.

Output: one JSON line per channel count with host ms/block,
us/epoch/channel, and the implied system ceiling when combined with a
given device x-real-time for the tracking block.

Usage: python tools/host_cost_probe.py [block_epochs=2000] [blocks=30]
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from stm32f4_sdr_gps_tpu.config import CODES_IN_BIT, ReceiverConfig  # noqa: E402
from stm32f4_sdr_gps_tpu.runtime.digest import BlockDigest  # noqa: E402
from stm32f4_sdr_gps_tpu.runtime.receiver import ChannelStatus, Receiver  # noqa: E402
from stm32f4_sdr_gps_tpu.signal.nav_message import build_bitstream  # noqa: E402
from stm32f4_sdr_gps_tpu.signal.scenarios import CANONICAL_EPH  # noqa: E402


def make_digests(n_chan: int, block_epochs: int, n_blocks: int,
                 cib: int = CODES_IN_BIT):
    """Digest stream carrying a real decodable LNAV bitstream per
    channel (each channel offset by its index so framer states differ)."""
    bits = build_bitstream(dict(CANONICAL_EPH, week=2290),
                           start_tow_6s=58810, num_subframes=5,
                           subframe_ids=(5, 1, 2, 3, 4))
    bits = np.tile(bits, 8)                 # long enough for any run
    rng = np.random.default_rng(0)
    cap = block_epochs // cib + 8
    digests = []
    bit_cursor = np.arange(n_chan) % 37     # desync the channels
    for b in range(n_blocks):
        epoch0 = b * block_epochs
        n_bits = block_epochs // cib
        bit_value = np.zeros((cap, n_chan), np.int8)
        bit_epoch = np.zeros((cap, n_chan), np.int32)
        for k in range(n_bits):
            idx = (bit_cursor + k) % len(bits)
            bit_value[k] = bits[idx]
            bit_epoch[k] = epoch0 + k * cib
        bit_cursor += n_bits
        digests.append(BlockDigest(
            bit_count=np.full(n_chan, n_bits, np.int32),
            bit_value=bit_value,
            bit_epoch=bit_epoch,
            code_phase_chips=rng.uniform(0, 1023, n_chan).astype(np.float32),
            code_phase_filtered=rng.uniform(0, 1023, n_chan)
            .astype(np.float32),
            doppler_hz=rng.uniform(-4e3, 4e3, n_chan).astype(np.float32),
            doppler_sum=rng.uniform(-4e6, 4e6, n_chan).astype(np.float32),
            snr_db=np.full(n_chan, 12.0, np.float32),
            period_sync_ok=np.ones(n_chan, bool),
            sync_any_loss=np.zeros(n_chan, bool),
            last_unsync_epoch=np.full(n_chan, -1, np.int32),
            cn0_m2=np.full(n_chan, 1e5, np.float32),
            cn0_m4=np.full(n_chan, 1.5e10, np.float32),
            cn0_n=np.full(n_chan, block_epochs - 2 * n_bits, np.int32),
            flip_hist=np.zeros((cib, n_chan), np.int32),
            first_ip_sign=np.ones(n_chan, np.int8),
            last_ip_sign=np.ones(n_chan, np.int8),
            code_phase_first=rng.uniform(0, 1023, n_chan)
            .astype(np.float32),
            swap_residue=np.zeros(n_chan, np.int32),
        ))
    return digests


def measure(n_chan: int, block_epochs: int, n_blocks: int):
    # solve disabled: it is CADENCE-bound (one Gauss-Newton fit per
    # 500 ms regardless of channel count, ~1 ms measured in the e2e
    # profiler) while this probe isolates the per-channel-linear work
    cfg = ReceiverConfig(prns=tuple((i % 32) + 1 for i in range(n_chan)),
                         enable_position=False)
    rx = Receiver(cfg)
    rx.channels = [ChannelStatus(prn=p, framer=rx._new_framer())
                   for p in cfg.prns]
    digests = make_digests(n_chan, block_epochs, n_blocks)
    # warm-up block (framer preamble search ramps up)
    rx._consume_digest(digests[0], block_epochs)
    rx.epoch_cursor += block_epochs
    t0 = time.perf_counter()
    for d in digests[1:]:
        rx._consume_digest(d, block_epochs)
        rx.epoch_cursor += block_epochs
    wall = time.perf_counter() - t0
    n = n_blocks - 1
    subfr = sum(ch.subframe_count for ch in rx.channels)
    return {
        "channels": n_chan,
        "block_epochs": block_epochs,
        "host_ms_per_block": round(wall / n * 1e3, 3),
        "host_us_per_epoch": round(wall / n / block_epochs * 1e6, 3),
        "host_us_per_epoch_per_chan": round(
            wall / n / block_epochs / n_chan * 1e6, 4),
        "host_only_rt_x": round(block_epochs * 1e-3 / (wall / n), 1),
        "subframes_decoded": subfr,
    }


def main():
    block_epochs = int(sys.argv[1]) if len(sys.argv) > 1 else 2000
    n_blocks = int(sys.argv[2]) if len(sys.argv) > 2 else 30
    for n_chan in (32, 128, 256):
        r = measure(n_chan, block_epochs, n_blocks)
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
