"""Batched GPS L1 C/A software-defined receiver in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
iliasam/STM32F4_SDR_GPS (see SURVEY.md): FFT-parallel acquisition,
batched multi-channel DLL/PLL/FLL tracking via ``lax.scan``, nav-message
decode, and least-squares PVT, on one GPU or a mesh of them.
"""

__version__ = "0.1.0"

from . import config  # noqa: F401
