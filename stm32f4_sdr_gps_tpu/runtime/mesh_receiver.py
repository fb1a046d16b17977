"""Mesh-sharded streaming receiver (BASELINE config 5 shape).

A :class:`~stm32f4_sdr_gps_tpu.runtime.receiver.Receiver` whose device
stages run on an explicit ``jax.sharding.Mesh``:

* acquisition shards PRNs over ``chan`` and epoch blocks over ``time``
  with ``psum`` merge (parallel.streaming.acquire_sharded);
* tracking keeps the channel axis sharded across every device with
  state resident between blocks (parallel.streaming.StreamingTracker);
* the device digest (runtime.digest) runs per channel shard inside the
  same shard_map as the tracking scan, so the default readback is the
  ~kB gathered digest — full (T, C) readback only when the aided-sync
  chain or correlator diagnostics genuinely need it (same rule as the
  single-device Receiver);
* the dynamic channel-set operations (``maybe_reacquire`` /
  ``drop_dead_channels`` / ``warm_reset``) run the base Receiver logic
  on the un-padded live state and re-shard the result with ghost-channel
  padding to a mesh multiple.

Host-side decode/PVT is unchanged — nav bits are 50 bps/channel, far
below any host boundary's bandwidth.  On a multi-process mesh each host
would run the framers for its own channel shard; this class targets the
single-process view (one controller, N devices).
"""

from __future__ import annotations

from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from ..acquire.engine import AcqResult
from ..parallel.mesh import shard_code_table, shard_track_state
from ..parallel.streaming import StreamingTracker, acquire_sharded
from ..signal.ca_code import ca_table_bipolar
from ..track.state import init_state
from ..track.pretrack import refine_code_phase
from .receiver import Receiver


class MeshReceiver(Receiver):
    """Receiver with mesh-sharded acquisition and tracking."""

    def __init__(self, config, mesh: Mesh):
        super().__init__(config)
        self.mesh = mesh
        self.tracker: Optional[StreamingTracker] = None
        self._n_live = 0

    def acquire_all(self, samples: np.ndarray,
                    extra_hints: Optional[dict] = None) -> List[AcqResult]:
        cfg = self.config
        hints = {}
        for prn, h in zip(cfg.prns, cfg.doppler_hints_hz or ()):
            if h is not None:
                hints[int(prn)] = float(h)
        if extra_hints:
            hints.update(extra_hints)
        results = acquire_sharded(
            samples, list(cfg.prns), self.mesh, cfg.plan, cfg.acq,
            doppler_hints_hz=hints or None,
        )
        for ch, res in zip(self.channels, results):
            ch.acq = res
            ch.state_name = "ACQ_DONE" if res.detected else "ACQ_FAILED"
        return results

    def start_tracking(self, samples: np.ndarray,
                       start_epoch: int = 0) -> None:
        cfg = self.config
        live = [ch for ch in self.channels if ch.acq and ch.acq.detected]
        if not live:
            raise RuntimeError("no channels acquired")
        self.standby_channels = [
            ch for ch in self.channels
            if ch not in live and ch not in self.standby_channels
        ] + self.standby_channels
        # pad the channel set to a mesh multiple with ghost copies of the
        # first channel (their outputs are ignored)
        n_dev = self.mesh.devices.size
        pad = (-len(live)) % n_dev
        tracked = live + live[:1] * pad
        prns = [ch.prn for ch in tracked]
        self.channels = live
        self._n_live = len(live)

        table = ca_table_bipolar(prns)
        phases = np.array([ch.acq.code_phase_chips for ch in tracked])
        from ..acquire.engine import refine_doppler_device

        spe = cfg.plan.samples_per_epoch
        e = min(256 if cfg.track.coherent_pll else 32,
                len(samples) // spe)
        fine_ep = jnp.asarray(
            samples[: e * spe].reshape(e, spe), jnp.complex64)
        dopplers = np.asarray(refine_doppler_device(
            fine_ep, jnp.asarray(table),
            jnp.asarray(phases, jnp.float32),
            jnp.asarray([ch.acq.doppler_hz for ch in tracked],
                        jnp.float32),
            cfg.plan,
        )).astype(np.float64)
        refined = refine_code_phase(
            samples, table, phases, dopplers, cfg.plan, cfg.track
        )
        state = init_state(len(tracked), refined, dopplers,
                           start_epoch=start_epoch,
                           window=cfg.track.pll_check_window)
        self.tracker = StreamingTracker(
            state, table, self.mesh, cfg.plan, cfg.track)
        for ch in live:
            ch.state_name = "TRACKING"

    def process_block(self, samples: np.ndarray) -> None:
        cfg = self.config
        spe = cfg.plan.samples_per_epoch
        n_epochs = len(samples) // spe
        epochs = jnp.asarray(
            samples[: n_epochs * spe].reshape(n_epochs, spe), jnp.complex64)
        if self._digest_active:
            # per-shard device digest: the (T, C) outputs never leave
            # the devices; only the gathered ~kB digest reaches the host
            with self.profiler.stage(
                "track", budget_s=n_epochs * 1e-3
            ).time():
                d = self.tracker.process_digest(
                    samples[: n_epochs * spe], cfg)
            d = jax.tree.map(np.asarray, d)
            with self.profiler.stage("decode").time():
                self._consume_digest(d, n_epochs)
            # aided bit sync operates on the sharded state directly:
            # the engage updates are elementwise jnp.where ops, so the
            # result feeds straight back into the sharded scan
            self.track_state = self.tracker.state
            self._aided_sync_from_digest(d, n_epochs, epochs)
            self.tracker.state = self.track_state
            self.epoch_cursor += n_epochs
            return
        with self.profiler.stage("track", budget_s=n_epochs * 1e-3).time():
            outs = self.tracker.process(samples[: n_epochs * spe])
        with self.profiler.stage("decode").time():
            self._consume_outputs(outs, n_epochs)
        self.track_state = self.tracker.state
        self._maybe_aided_sync(outs, n_epochs, epochs)
        self.tracker.state = self.track_state
        self.epoch_cursor += n_epochs
        # track_state doubles as the checkpoint alias (runtime.checkpoint
        # reads it; restoring a MeshReceiver yields a plain Receiver —
        # re-shard with StreamingTracker to resume on a mesh)

    # -- dynamic channel set on a sharded tracker --------------------------

    def _sync_live_from_tracker(self) -> None:
        """Expose the un-padded live state/table as self.track_state /
        self.code_table so the base Receiver's channel-set logic can
        operate on them."""
        n = self._n_live
        self.track_state = jax.tree.map(lambda x: x[:n], self.tracker.state)
        self.code_table = self.tracker.code_table[:n]

    def _reshard_to_tracker(self) -> None:
        """Re-pad the (possibly re-sized) live state to a mesh multiple
        with ghost copies of channel 0 and place it back on the mesh."""
        st, tbl = self.track_state, self.code_table
        n = int(tbl.shape[0])
        pad = (-n) % self.mesh.devices.size

        def _pad(x):
            if pad == 0:
                return x
            return jnp.concatenate(
                [x, jnp.repeat(x[:1], pad, axis=0)], axis=0)

        self.tracker.state = shard_track_state(
            jax.tree.map(_pad, st), self.mesh)
        self.tracker.code_table = shard_code_table(_pad(tbl), self.mesh)
        self._n_live = n

    def maybe_reacquire(self, recent_samples: np.ndarray) -> List[int]:
        if self.tracker is None:
            return super().maybe_reacquire(recent_samples)
        self._sync_live_from_tracker()
        added = super().maybe_reacquire(recent_samples)
        self._reshard_to_tracker()
        return added

    def drop_dead_channels(self, cn0_floor_dbhz: float = None,
                           grace_ms: int = None) -> List[int]:
        if self.tracker is None:
            return super().drop_dead_channels(cn0_floor_dbhz, grace_ms)
        self._sync_live_from_tracker()
        dropped = super().drop_dead_channels(cn0_floor_dbhz, grace_ms)
        self._reshard_to_tracker()
        return dropped
