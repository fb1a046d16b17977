"""Multi-device streaming receiver front end.

BASELINE.json config 5 capability: long IQ captures with time-blocks
sharded across the mesh's ``time`` axis and PRN channels across ``chan``.

* Acquisition is embarrassingly parallel over time-blocks: each shard
  integrates its local epochs non-coherently and the partial power cubes
  merge with ``psum`` (mesh.sharded_acquisition_power).
* Tracking is sequential in time by nature (1 ms loop closure,
  SURVEY.md §7 hard part (a)); its parallel axis is channels.  The
  streaming driver therefore pipelines: sharded acquisition over the
  whole capture first, then the channel-sharded tracking scan consumes
  time-blocks in order.
* Block boundaries: epochs are self-contained 1 ms circular-correlation
  windows, so acquisition needs no halo; the halo exchange
  (mesh.halo_extend_blocks) exists for sample-granular block splits
  (e.g. re-centering epoch windows mid-stream after a code wrap).
"""

from __future__ import annotations

from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from ..acquire.engine import (
    AcqResult, analyze_power, apply_doppler_hints, dft_precision_enum)
from ..config import AcqConfig, SignalPlan, BASEBAND_PLAN
from ..ops.correlate import (
    code_fft_conj,
    code_spectrum_conj_matmul,
    dft_tables_device,
    pack_code_bits,
    unpack_code_table,
)
from ..ops.wipeoff import doppler_rotations
from ..track.scan import track_block
from ..track.state import TrackState
from .mesh import (
    replicated,
    shard_code_table,
    shard_track_state,
    sharded_acquisition_power,
)


def acquire_sharded(
    samples: np.ndarray,
    prns,
    mesh: Mesh,
    plan: SignalPlan = BASEBAND_PLAN,
    cfg: AcqConfig = AcqConfig(),
    num_epochs: Optional[int] = None,
    doppler_hints_hz: Optional[dict] = None,
) -> List[AcqResult]:
    """Mesh-sharded cold acquisition over a capture.

    PRNs shard over ``chan`` (pad to a multiple), epochs over ``time``.
    ``doppler_hints_hz`` confines hinted PRNs to hint +/- one bin, same
    as the single-device ``acquire()``.
    """
    s = plan.samples_per_epoch
    e = num_epochs or cfg.noncoherent_epochs
    nt = mesh.shape["time"]
    nc = mesh.shape["chan"]
    e = (max(e, nt) // nt) * nt
    if len(samples) < e * s:
        raise ValueError(f"need {e} epochs of samples")
    epochs = jnp.asarray(samples[: e * s].reshape(e, s), jnp.complex64)

    prns = list(prns)
    pad = (-len(prns)) % nc
    padded = prns + prns[:pad]          # repeat head PRNs as padding
    bins = np.asarray(cfg.doppler_bins_hz, dtype=np.float32)
    rot = doppler_rotations(jnp.asarray(bins), s, plan.sample_rate_hz)
    dft = None
    if cfg.use_matmul_dft:
        # matmul-DFT build (acquire.engine semantics)
        dft = dft_tables_device(s)
        packed = jnp.asarray(pack_code_bits(padded, plan))
        cfc = code_spectrum_conj_matmul(unpack_code_table(packed, s), *dft)
    else:
        cfc = code_fft_conj(padded, plan)
    with jax.sharding.set_mesh(mesh):
        power = sharded_acquisition_power(
            epochs, cfc, rot, mesh, dft=dft,
            dft_precision=dft_precision_enum(cfg))
        power.block_until_ready()
    # the sharded cube stays on the mesh: PRN-pad slice, hint mask and
    # peak analysis are device ops; only (P,) scalars reach the host
    power = power[: len(prns)]
    power = apply_doppler_hints(power, prns, bins, doppler_hints_hz, cfg)
    return analyze_power(power, prns, bins, plan, cfg)


class StreamingTracker:
    """Channel-sharded tracking over sequential time-blocks.

    The host feeds blocks in order (from a file, the native ring buffer,
    or a network stream); the device state stays resident and sharded
    across the mesh between calls — the batched analogue of the
    firmware's resident per-channel state advanced by the 1 ms ISR.
    """

    def __init__(self, state: TrackState, code_table, mesh: Mesh,
                 plan: SignalPlan, cfg):
        self.mesh = mesh
        self.plan = plan
        self.cfg = cfg
        # the WHOLE mesh (time axis included) acts as one channel axis
        # for tracking — time cannot shard a 1 ms feedback loop.  A
        # non-divisible channel count would otherwise surface as a
        # cryptic shard_map partitioning error (advisor finding r2).
        n_chan = int(np.shape(code_table)[0])
        n_dev = int(mesh.devices.size)
        if n_chan % n_dev:
            raise ValueError(
                f"StreamingTracker: {n_chan} channels do not divide over "
                f"the {n_dev}-device mesh (all mesh axes shard the "
                f"channel axis); pad the channel set to a multiple — "
                f"MeshReceiver.start_tracking shows the ghost-channel "
                f"pattern")
        self.state = shard_track_state(state, mesh)
        self.code_table = shard_code_table(jnp.asarray(code_table), mesh)
        # cached jitted shard_map callables: shard_map re-traces (and
        # the whole program re-compiles) on EVERY bare call, so a
        # receiver dispatching one block per call was recompiling the
        # tracking scan per block — ~9 s/block of pure retrace on the
        # CPU mesh (this was the test suite's dominant cost).  Keyed by
        # block length + channel shape; cleared when the channel set
        # changes (re-shard paths assign state/code_table directly).
        self._fn_cache: dict = {}

    def process(self, samples: np.ndarray):
        """Advance all channels through one block of whole epochs."""
        s = self.plan.samples_per_epoch
        n = len(samples) // s
        epochs = jnp.asarray(samples[: n * s].reshape(n, s), jnp.complex64)
        with jax.sharding.set_mesh(self.mesh):
            epochs = replicated(epochs, self.mesh)
            self.state, outs = track_block(
                self.state, epochs, self.code_table, self.plan, self.cfg
            )
        return outs

    def process_digest(self, samples: np.ndarray, cfg_recv):
        """Advance one block AND reduce it to a BlockDigest per channel
        shard — the mesh form of runtime._track_and_digest.

        Each device digests its own channel subset inside the shard_map
        (the digest is channel-independent), so the only device→host
        traffic a consumer needs is the ~kB of gathered digest leaves —
        never the (T, C) outputs."""
        from jax.sharding import PartitionSpec as P

        from ..runtime.digest import digest_block

        s = self.plan.samples_per_epoch
        n = len(samples) // s
        epochs = jnp.asarray(samples[: n * s].reshape(n, s), jnp.complex64)
        axes = tuple(self.mesh.axis_names)

        def local(st, tbl, ep):
            st2, outs = track_block(st, ep, tbl, self.plan, self.cfg)
            return st2, digest_block(outs, st2, self.cfg,
                                     cfg_recv.code_filter_len,
                                     cfg_recv.enable_code_filter)

        def lead_spec(x):
            return P(axes, *([None] * (x.ndim - 1)))

        key = ("digest", epochs.shape, self.code_table.shape,
               cfg_recv.code_filter_len, cfg_recv.enable_code_filter)
        fn = self._fn_cache.get(key)
        if fn is None:
            st_specs = jax.tree.map(lead_spec, self.state)
            _, d_shapes = jax.eval_shape(local, self.state,
                                         self.code_table, epochs)
            d_specs = jax.tree.map(
                lambda x: P(None, axes) if x.ndim == 2 else P(axes),
                d_shapes)
            fn = jax.jit(jax.shard_map(
                local,
                mesh=self.mesh,
                in_specs=(st_specs, P(axes, None), P(None, None)),
                out_specs=(st_specs, d_specs),
            ))
            self._fn_cache[key] = fn
        self.state, d = fn(self.state, self.code_table, epochs)
        return d
