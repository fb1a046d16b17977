"""Which device a measurement ran on, for every line that reports one.

A number from a run is only meaningful beside the card it came from, and
a card may be set below its maximum power limit (it then runs slower
under load).  ``nvidia-smi`` gives the name and limit; it is run as a
child process that does not import JAX, so it never holds the card.
"""

from __future__ import annotations

import subprocess

SMI_QUERY = ("nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader")


def card_lines() -> list:
    """One ``"<name>, <limit> W"`` line per card, as nvidia-smi prints
    them.  Raises when nvidia-smi is missing or fails."""
    out = subprocess.run(SMI_QUERY, capture_output=True, text=True,
                         check=True, timeout=60).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def parse_card_line(line: str) -> tuple:
    """``"NVIDIA H100 80GB HBM3, 700.00 W"`` -> (name, 700.0).  The
    limit is None when the card does not report one (``[N/A]``)."""
    name, sep, limit = line.rpartition(",")
    if not sep:
        raise ValueError(f"not a name,power.limit line: {line!r}")
    try:
        watts = float(limit.strip().split()[0])
    except (IndexError, ValueError):
        watts = None
    return name.strip(), watts


def require_gpu(devices) -> None:
    """Refuse to measure anything unless JAX's default device is a GPU
    (no fallback to the CPU backend)."""
    platform = devices[0].platform if devices else "none"
    if platform != "gpu":
        raise SystemExit(
            f"needs a GPU as JAX's default device; found {platform!r}")


def device_record(devices) -> dict:
    """The device as JAX reports it (platform, kind, count)."""
    d = devices[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devices)}
