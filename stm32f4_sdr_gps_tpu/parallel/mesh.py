"""Device-mesh scaling: sharded acquisition and tracking.

The reference is a uniprocessor; its concurrency structures (TDM channel
multiplexing, Doppler-bin serial scan, ISR double-buffering) map to mesh
axes here (SURVEY.md §2.3):

* ``chan`` axis — satellite channels / PRN rows of the acquisition cube,
  sharded across chips (replaces TDM multiplexing, main.c:140-155);
* ``time`` axis — capture time-blocks, sharded across chips/hosts for
  non-coherent integration; partial power sums merge with ``psum``
  (replaces the serial 10-epochs-per-bin scan, acquisition.c:280-312).

Everything uses ``shard_map`` over an explicit ``jax.sharding.Mesh`` so
the same code runs on several GPUs of one host or on the virtual CPU
mesh used in tests.  Every GPU reaches every other over NVLink at the
same rate, so the mesh shape follows the algorithm alone.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.correlate import (
    fft_circular_correlate,
    matmul_circular_correlate,
    noncoherent_power,
)
from ..track.state import TrackState


def make_mesh(time: int = 1, chan: Optional[int] = None,
              devices=None) -> Mesh:
    """Build a (time, chan) mesh over the available devices."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if chan is None:
        chan = n // time
    if time * chan != n:
        raise ValueError(f"mesh {time}x{chan} != {n} devices")
    dev_array = np.asarray(devices).reshape(time, chan)
    return Mesh(dev_array, axis_names=("time", "chan"))


# ---------------------------------------------------------------------------
# Acquisition: PRN axis over `chan`, epoch blocks over `time`, psum merge.
# ---------------------------------------------------------------------------

def sharded_acquisition_power(
    epochs: jnp.ndarray,     # (E, S) — E divisible by mesh.shape['time']
    cfc: jnp.ndarray,        # (P, S) — P divisible by mesh.shape['chan']
    rot: jnp.ndarray,        # (D, S) doppler rotations, replicated
    mesh: Mesh,
    gather_output: bool = False,   # replicate the cube on every device
    #   (multi-process runs need a fully-addressable result)
    dft: tuple | None = None,  # (wc, ws) replicated matmul-DFT tables —
    #   matmul path (acquire.engine semantics); None = FFT path
    dft_precision=None,        # lax precision of the DFT matmuls
    #   (acquire.engine.dft_precision_enum; None = HIGHEST)
) -> jnp.ndarray:
    """Full non-coherent power cube (P, D, S), computed with epochs
    sharded over the ``time`` axis and PRNs over ``chan``; the partial
    integrations combine via ``psum`` across ``time`` (the ICI
    collective equivalent of the firmware's sequential histogram
    accumulation)."""

    def local(epochs_l, cfc_l, rot_l, *dft_l):
        def body(acc, x):
            xd = x[None, :] * rot_l                    # (D, S)
            if dft_l:                                  # matmul-DFT
                corr = matmul_circular_correlate(
                    xd, cfc_l, *dft_l,
                    precision=dft_precision or jax.lax.Precision.HIGHEST)
            else:
                corr = fft_circular_correlate(xd, cfc_l)   # (D, Pl, S)
            return acc + noncoherent_power(corr).transpose(1, 0, 2), None

        p_l, s = cfc_l.shape
        acc0 = jnp.zeros((p_l, rot_l.shape[0], s), jnp.float32)
        # mark the fresh carry as varying over the manual mesh axes so the
        # scan carry types match (JAX>=0.9 shard_map VMA tracking)
        pcast = getattr(jax.lax, "pcast", None)
        if pcast is not None:
            acc0 = pcast(acc0, ("time", "chan"), to="varying")
        acc, _ = jax.lax.scan(body, acc0, epochs_l)
        acc = jax.lax.psum(acc, axis_name="time")
        if gather_output:
            acc = jax.lax.all_gather(acc, "chan", axis=0, tiled=True)
        return acc

    extra = () if dft is None else tuple(dft)
    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P("time", None), P("chan", None), P(None, None))
        + tuple(P(None, None) for _ in extra),
        out_specs=P(None, None, None) if gather_output
        else P("chan", None, None),
        # the VMA checker can't infer that a tiled all_gather over
        # 'chan' makes the result replicated
        check_vma=not gather_output,
    )
    return fn(epochs, cfc, rot, *extra)


# ---------------------------------------------------------------------------
# Tracking: channel axis sharded across the whole mesh.
# ---------------------------------------------------------------------------

def channel_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Sharding that splits the leading (channel) axis over every mesh
    device; remaining axes replicated."""
    spec = P(("time", "chan"), *([None] * (ndim - 1)))
    return NamedSharding(mesh, spec)


def shard_track_state(state: TrackState, mesh: Mesh) -> TrackState:
    """Place every TrackState leaf with its channel axis sharded."""
    return jax.tree.map(
        lambda x: jax.device_put(
            x, channel_sharding(mesh, np.ndim(x))
        ),
        state,
    )


def shard_code_table(code_table, mesh: Mesh):
    return jax.device_put(code_table, channel_sharding(mesh, 2))


def replicated(x, mesh: Mesh):
    return jax.device_put(x, NamedSharding(mesh, P()))


# ---------------------------------------------------------------------------
# Overlap-save halo exchange for time-sharded sample blocks.
# ---------------------------------------------------------------------------

def halo_extend_blocks(blocks: jnp.ndarray, halo: int, mesh: Mesh,
                       axis: str = "time") -> jnp.ndarray:
    """Append each time-shard's first ``halo`` samples to its *left*
    neighbour (overlap-save): a block that ends mid-correlation-window
    can finish it locally.  (B, N) sharded on B over ``axis`` →
    (B, N + halo) with blocks[i, N:] = blocks[i+1, :halo] (last block
    zero-padded).  Uses ``ppermute`` — ICI neighbor exchange, the
    Device form of the firmware's ISR↔mainline double-buffer copy
    handshake (signal_capture.c:100-141, SURVEY.md §2.3)."""
    n_shards = mesh.shape[axis]

    def local(b):
        # b: (B/n, N) local block rows
        head = b[:1, :halo]                     # first row's head
        # send my head to my left neighbor
        perm = [(i, (i - 1) % n_shards) for i in range(n_shards)]
        recv = jax.lax.ppermute(head, axis_name=axis, perm=perm)
        idx = jax.lax.axis_index(axis)
        recv = jnp.where(idx == n_shards - 1, jnp.zeros_like(recv), recv)
        # intra-shard: row i extends with row i+1's head; last row uses recv
        intra = jnp.concatenate([b[1:, :halo], recv], axis=0)
        return jnp.concatenate([b, intra], axis=1)

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=P(axis, None),
        out_specs=P(axis, None),
    )
    return fn(blocks)
