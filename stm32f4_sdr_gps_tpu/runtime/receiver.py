"""Streaming receiver: acquisition → pre-track → tracking → decode → PVT.

The batched counterpart of the firmware's orchestration layer
(``main.c`` dispatch loop + ``gps_master.c`` channel sequencing).  The
firmware interleaves acquisition and tracking under a 1 ms hard-real-time
budget with TDM channel slots; here each stage is an explicit batched
program over a recorded/streamed capture:

1. **Acquire** — FFT cube over all PRNs at once (replaces the
   channel-at-a-time frequency search sequencing, gps_master.c:91-120).
2. **Pre-track** — vectorized code-phase refinement (tracking.c:398-499).
3. **Track** — jitted ``lax.scan`` blocks over epochs, all channels
   batched; device outputs stream to the host.
4. **Decode** — per-channel nav framers consume 20 ms bit events;
   subframes update ephemerides (nav_data.c / nav_data_decode.c roles).
5. **Solve** — observables formed on the sample ledger at the solve
   cadence, Gauss-Newton PVT (gps_master.c:392-425).

The whole receiver state is checkpointable (runtime.checkpoint).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..acquire.engine import AcqResult, acquire
from ..config import ReceiverConfig, WORDS_IN_SUBFRAME, WORD_LENGTH_BITS
from ..nav.ephemeris import Ephemeris, decode_subframe, getbitu
from ..nav.frame import NavFramer
from ..pvt.observables import (ChannelObservables, HatchState,
                               boundary_arrival_ms, form_observations)
from ..pvt.solve import Solution, pntpos
from ..signal.ca_code import ca_table_bipolar
from ..track.pretrack import refine_code_phase
from ..track.scan import track_block
from ..track.state import TrackState, concat_states, init_state
from ..utils.profiling import Profiler
from .digest import digest_block


@functools.partial(
    jax.jit,
    static_argnames=("plan", "cfg", "code_filter_len",
                     "enable_code_filter"),
)
def _track_and_digest(state, epochs, code_table, plan, cfg,
                      code_filter_len, enable_code_filter):
    """Tracking scan + on-device block digest in ONE jit: the (T, C)
    outputs never materialize on the host (runtime.digest)."""
    state, outs = track_block(state, epochs, code_table, plan, cfg)
    return state, digest_block(outs, state, cfg, code_filter_len,
                               enable_code_filter)


@dataclass
class ChannelStatus:
    """Host-side per-channel bookkeeping (the gps_ch_t role)."""

    prn: int
    acq: Optional[AcqResult] = None
    framer: NavFramer = field(default_factory=NavFramer)
    eph: Ephemeris = field(default_factory=Ephemeris)
    subframe_time_ms: int = 0     # last subframe boundary (ledger ms)
    subframe_tow_s: float = 0.0   # TOW labelling that boundary
    # recent boundary residues on the nav-bit grid, for de-jittering
    boundary_residues: list = field(default_factory=list)
    hatch: HatchState = field(default_factory=HatchState)
    subframe_count: int = 0
    bit_count: int = 0
    snr_db: float = 0.0
    cn0_dbhz: float = 0.0
    carrier_cycles: float = 0.0   # integrated Doppler (L observable)
    rtcm_phase_align_m: float = 0.0   # phaserange = align - lambda*L
    # Costas half-cycle ambiguity state: +1 = carrier in phase with nav
    # bits, -1 = PLL locked pi out of phase (the framer sees inverted
    # polarity; true phase = measured + 1/2 cycle), 0 = never resolved.
    # half_cycle keeps the LAST resolved value through polarity-timeout
    # gaps so the correction stays continuous; half_cycle_known gates
    # the MSM DF420 ambiguity flag.
    half_cycle: int = 0
    half_cycle_known: bool = False
    doppler_hz: float = 0.0
    code_phase_chips: float = 0.0
    state_name: str = "IDLE"
    bit_synced: bool = False      # period sync (coherent PLL engaged
    #                               when cfg.track.coherent_pll)
    # standby-search bookkeeping (acquisition.c:13, :217-224 semantics):
    # learned Doppler hint confining re-acquisition, and the epoch the
    # current search started — after AcqConfig.timeout_ms of continuous
    # failure the hint is discarded and the search widens to full grid
    acq_hint_hz: Optional[float] = None
    acq_search_start_ms: int = -1
    acq_timeouts: int = 0
    # continuous-lock ledger for the MSM DF402 lock-time indicator:
    # epoch (ledger ms) at which the current uninterrupted bit-sync
    # span began; -1 = not locked.  Bit sync is the receiver's proxy
    # for continuous carrier lock (losing it means the phase history
    # is no longer trustworthy, so the phaserange also re-aligns).
    lock_start_ms: int = -1
    # persistent integer-ms correction to the channel's subframe
    # boundary ledger, set when identify_grid_fault pins a wrong nav-bit
    # grid on this channel (the slip-floor failure mode); applied to
    # every observation the channel contributes until the grid re-syncs
    grid_bias_ms: int = 0
    grid_faults: int = 0
    # demotion ledger: last epoch the channel's measured C/N0 cleared
    # the configured floor (ReceiverConfig.cn0_floor_dbhz); set to the
    # join epoch at tracking start so new channels get the full grace
    # window before drop_dead_channels can demote them
    last_healthy_ms: int = -1


def _m2m4_cn0(ip: np.ndarray, qp: np.ndarray,
              epoch_s: float = 1e-3) -> float:
    """C/N0 (dB-Hz) from prompt correlator moments (M2M4 estimator).

    The firmware's I/Q power-ratio SNR (tracking.c:147-169, kept as
    snr_db) saturates above ~45 dBHz; the second/fourth-moment method is
    accurate to <1 dB over 30-50 dBHz on simulated captures."""
    p = ip.astype(np.float64) ** 2 + qp.astype(np.float64) ** 2
    if len(p) < 16:
        return 0.0
    m2 = p.mean()
    m4 = (p * p).mean()
    pd = np.sqrt(max(2.0 * m2 * m2 - m4, 0.0))
    pn = m2 - pd
    if pd <= 0.0 or pn <= 0.0:
        return 0.0
    return float(10.0 * np.log10(pd / pn / epoch_s))


def dejitter_boundary(ch: ChannelStatus, boundary: int, cib: int) -> int:
    """Snap a detected subframe boundary to the channel's nav-bit grid.

    Bit-edge detection can slip +/-1 epoch under noise when the edge
    lies near an epoch midpoint, which would shift the reconstructed
    pseudorange by a full ms (300 km) — the error class behind the
    firmware's accurate-sync refinement (nav_data.c:145-218).
    Boundaries repeat on the bit grid, so the median residue of
    recent detections identifies and removes isolated slips.
    """
    res = boundary % cib
    hist = ch.boundary_residues
    hist.append(res)
    del hist[:-5]
    if len(hist) >= 3:
        med = int(np.median(hist))
        delta = (res - med + cib // 2) % cib - cib // 2
        boundary -= delta
    return boundary


def push_channel_bit(ch: ChannelStatus, value: int, epoch: int,
                     codes_in_bit: int) -> None:
    """One demodulated nav bit → framer → subframe/ephemeris/ledger.

    Module-level so per-process shard decoders (runtime.multiprocess)
    run the exact decode path the single-process Receiver does."""
    ch.bit_count += 1
    for sf in ch.framer.push_bit(value, epoch):
        decode_subframe(sf.bits, ch.eph)
        ch.eph.sat = ch.prn
        ch.subframe_count += 1
        # boundary the HOW TOW labels = subframe start + 6 s
        # (300 bits x codes_in_bit ms per bit)
        sf_ms = WORDS_IN_SUBFRAME * WORD_LENGTH_BITS * codes_in_bit
        boundary = dejitter_boundary(
            ch, sf.start_epoch_ms + sf_ms, codes_in_bit)
        ch.subframe_time_ms = boundary
        ch.subframe_tow_s = getbitu(sf.bits, 30, 17) * 6.0


@dataclass
class ReceiverReport:
    """Result of processing a capture."""

    channels: List[ChannelStatus]
    solutions: List[Solution]
    solution_epochs_ms: List[int]
    epochs_processed: int = 0


class Receiver:
    """Multi-channel GPS L1 C/A receiver over a sample stream."""

    def __init__(self, config: ReceiverConfig):
        self.config = config
        self.channels: List[ChannelStatus] = [
            ChannelStatus(prn=p, framer=self._new_framer())
            for p in config.prns
        ]
        self.track_state: Optional[TrackState] = None
        self.code_table = None       # (C, 1023) bipolar, on device
        self.epoch_cursor = 0        # global sample ledger, epochs (= ms)
        self.solutions: List[Solution] = []
        self.solution_epochs: List[int] = []
        self.rtcm_frames: List[bytes] = []
        self.standby_channels: List[ChannelStatus] = []
        self._last_solve_ms = 0
        self._last_rtcm_ms = 0
        self._last_reacq_ms = 0
        self._status_cb = None
        # aided-sync window state: accumulated sign-flip histogram
        # (cib, C), epochs accumulated, and the previous block's last
        # prompt sign per channel (cross-block flip detection)
        self._flip_hist: Optional[np.ndarray] = None
        self._flip_hist_ms = 0
        self._flip_prev_sign: Optional[np.ndarray] = None
        self._aided_low_conf = np.zeros(0, int)
        self._pending_phase = np.full(0, -1)
        self._pending_cnt = np.zeros(0, int)
        # sticky reference channel for carrier-phase clock re-basing
        # (_relative_L); 0 = unset, chosen at first observable formation
        self._phase_ref_prn = 0
        # per-stage wall-clock profiler (the DWT timer / solver
        # budget-alarm role, delay_us_timer.c + solving.c:119-138);
        # the 'track' stage budget is the real-time budget of one block
        self.profiler = Profiler()

    def _new_framer(self) -> NavFramer:
        """Framer with the polarity re-detect timeout scaled to the
        actual on-air bit duration (2 subframes = 600 bits; nav_data.c:22
        hardcodes 12 s because firmware bits are always 20 ms)."""
        return NavFramer(
            polarity_timeout_ms=600 * self.config.track.codes_in_bit)

    # -- stages -----------------------------------------------------------

    def acquire_all(self, samples: np.ndarray,
                    extra_hints: Optional[dict] = None) -> List[AcqResult]:
        """Stage 1: cold acquisition for every configured PRN.

        Doppler hints (main.c:59-73 capability) confine the grid for the
        hinted channel; ``extra_hints`` (e.g. from a warm reset) override
        the configured ones."""
        cfg = self.config
        hints = {}
        # doppler_hints_hz: () or None = cold search everywhere
        for prn, h in zip(cfg.prns, cfg.doppler_hints_hz or ()):
            if h is not None:
                hints[int(prn)] = float(h)
        if extra_hints:
            hints.update(extra_hints)
        with self.profiler.stage("acquire").time():
            results = acquire(samples, list(cfg.prns), cfg.plan, cfg.acq,
                              doppler_hints_hz=hints or None)
        for ch, res in zip(self.channels, results):
            ch.acq = res
            ch.state_name = "ACQ_DONE" if res.detected else "ACQ_FAILED"
        return results

    def start_tracking(self, samples: np.ndarray,
                       start_epoch: int = 0) -> None:
        """Stages 2-3 init: pre-track refinement + tracking state."""
        cfg = self.config
        live = [ch for ch in self.channels if ch.acq and ch.acq.detected]
        if not live:
            raise RuntimeError("no channels acquired")
        prns = [ch.prn for ch in live]
        self.standby_channels = [
            ch for ch in self.channels if ch not in live
        ]
        self.channels = live
        table_np = ca_table_bipolar(prns)
        phases = np.array([ch.acq.code_phase_chips for ch in live])
        # fine Doppler: long coherent FFT at the acquired code phase
        # (acquire.engine.refine_doppler_device) shrinks the handoff
        # error from tens of Hz to ~1 Hz.  The BATCHED device program
        # refines every channel in one dispatch — the per-channel host
        # variant embeds each PRN's code as a closure constant, i.e.
        # one XLA compile per PRN.
        from ..acquire.engine import refine_doppler_device

        # weak-signal (coherent) mode needs a longer squared-prompt span
        # to beat the squaring loss at ~30 dBHz
        fine_epochs = 256 if cfg.track.coherent_pll else 32
        spe = cfg.plan.samples_per_epoch
        e = min(fine_epochs, len(samples) // spe)
        fine_ep = jnp.asarray(
            samples[: e * spe].reshape(e, spe), jnp.complex64)
        dopplers = np.asarray(refine_doppler_device(
            fine_ep, jnp.asarray(table_np),
            jnp.asarray(phases, jnp.float32),
            jnp.asarray([ch.acq.doppler_hz for ch in live], jnp.float32),
            cfg.plan,
        )).astype(np.float64)
        with self.profiler.stage("pretrack").time():
            refined = refine_code_phase(
                samples, table_np, phases, dopplers, cfg.plan, cfg.track
            )
        self.code_table = jnp.asarray(table_np)
        self.track_state = init_state(
            len(live), refined, dopplers, start_epoch=start_epoch,
            window=cfg.track.pll_check_window,
        )
        for ch in live:
            ch.state_name = "TRACKING"
            ch.last_healthy_ms = start_epoch

    @property
    def _digest_active(self) -> bool:
        """Device-digest readback mode (runtime.digest): on unless a
        consumer genuinely needs the full (T, C) outputs on the host —
        only correlator diagnostics do.  The aided-sync weak-signal
        chain is digest-fed (flip_hist + refine_doppler_device), so the
        coherent 26-30 dBHz path runs fully device-resident."""
        cfg = self.config
        return cfg.device_digest and not cfg.track.emit_correlators

    def process_block(self, samples: np.ndarray) -> None:
        """Stages 3-5 for one block of whole epochs."""
        cfg = self.config
        spe = cfg.plan.samples_per_epoch
        n_epochs = len(samples) // spe
        epochs = jnp.asarray(
            samples[: n_epochs * spe].reshape(n_epochs, spe), jnp.complex64
        )
        if self._digest_active:
            # device-resident loop: the (T, C) outputs never leave the
            # device — one jit returns the new state + a ~kB digest.
            # The "track" stage times the dispatch only: the readback
            # below, which waits for the device, falls outside it.
            with self.profiler.stage(
                "track", budget_s=n_epochs * 1e-3
            ).time():
                self.track_state, d = _track_and_digest(
                    self.track_state, epochs, self.code_table,
                    cfg.plan, cfg.track, cfg.code_filter_len,
                    cfg.enable_code_filter
                )
            d = jax.tree.map(np.asarray, d)
            with self.profiler.stage("decode").time():
                self._consume_digest(d, n_epochs)
            self._aided_sync_from_digest(d, n_epochs, epochs)
            self.epoch_cursor += n_epochs
            return
        with self.profiler.stage("track", budget_s=n_epochs * 1e-3).time():
            self.track_state, outs = track_block(
                self.track_state, epochs, self.code_table, cfg.plan,
                cfg.track
            )
        with self.profiler.stage("decode").time():
            self._consume_outputs(outs, n_epochs)
        self._maybe_aided_sync(outs, n_epochs, epochs)
        self.epoch_cursor += n_epochs

    def _maybe_aided_sync(self, outs, n_epochs: int, epochs) -> None:
        """Aided-sync evaluation for the full-readback path: the same
        flip-histogram statistics the device digest computes, built on
        the host from the (T, C) outputs, feeding the shared decision
        logic (_aided_sync_step)."""
        cfg = self.config
        if not (cfg.track.coherent_pll and cfg.aided_sync_window_ms):
            return
        cib = cfg.track.codes_in_bit
        ip = np.asarray(outs.ip)
        signs = ip > 0
        flips = signs[1:] != signs[:-1]
        res = (self.epoch_cursor + np.arange(1, len(ip))) % cib
        hist = np.zeros((cib, ip.shape[1]), np.int64)
        for c in range(ip.shape[1]):
            hist[:, c] = np.bincount(res[flips[:, c]], minlength=cib)
        first = np.where(signs[0], 1, -1).astype(np.int8)
        last = np.where(signs[-1], 1, -1).astype(np.int8)
        sync_last = np.asarray(outs.period_sync_ok)[-1].astype(bool)
        grid_now = np.asarray(self.track_state.last_swap_epoch) % cib
        cp0 = np.asarray(outs.code_phase_chips)[0]
        self._aided_sync_step(hist, first, last, sync_last, grid_now,
                              cp0, n_epochs, epochs)

    def _aided_sync_from_digest(self, d, n_epochs: int, epochs) -> None:
        """Aided-sync evaluation from the device digest (numpy leaves):
        no (T, C) readback anywhere on this path."""
        cfg = self.config
        if not (cfg.track.coherent_pll and cfg.aided_sync_window_ms):
            return
        self._aided_sync_step(
            d.flip_hist.astype(np.int64), d.first_ip_sign, d.last_ip_sign,
            d.period_sync_ok.astype(bool), d.swap_residue,
            d.code_phase_first, n_epochs, epochs,
        )

    def _aided_sync_step(self, hist, first_sign, last_sign, sync_last,
                         grid_now, cp0, n_epochs: int, epochs) -> None:
        """Histogram bit-boundary search + squared-prompt Doppler
        re-anchor (track.aided_sync), evaluated every full prompt
        window.  Handles the two failure modes the run-time counters
        have at the C/N0 the coherent PLL targets: they may never
        declare sync, or worse, a random-walk excursion declares sync
        on a WRONG boundary which grid-locking would then freeze — a
        confident histogram that disagrees overrides it.

        ``hist`` is this block's (cib, C) sign-flip histogram keyed by
        global epoch residue; ``epochs`` is the block's (T, S) device
        array (re-anchor input).  All statistics are digest-sized."""
        cfg = self.config
        cib = cfg.track.codes_in_bit
        n_chan = hist.shape[1]
        # cross-block flip: the first epoch's sign vs the previous
        # block's last (the in-block histogram can't see that edge)
        if (self._flip_prev_sign is not None
                and len(self._flip_prev_sign) == n_chan):
            cross = self._flip_prev_sign != first_sign
            hist[self.epoch_cursor % cib] += cross.astype(np.int64)
        self._flip_prev_sign = np.asarray(last_sign)
        if self._flip_hist is None or self._flip_hist.shape != hist.shape:
            self._flip_hist = np.zeros_like(hist)
            self._flip_hist_ms = 0
        self._flip_hist += hist
        self._flip_hist_ms += n_epochs
        if self._flip_hist_ms < cfg.aided_sync_window_ms:
            return
        from ..track.aided_sync import (boundary_from_flip_hist,
                                        engage_bit_sync)

        phases, confs = boundary_from_flip_hist(self._flip_hist)
        self._flip_hist = None   # fresh window each evaluation
        self._flip_hist_ms = 0
        if len(self._pending_phase) != n_chan:
            self._pending_phase = np.full(n_chan, -1)
            self._pending_cnt = np.zeros(n_chan, int)

        # two-consecutive-window phase agreement (within the +/-1
        # split-edge ambiguity)
        usable = confs >= cfg.aided_sync_repeat_sigma
        pdist = np.minimum((phases - self._pending_phase) % cib,
                           (self._pending_phase - phases) % cib)
        agree = usable & (self._pending_phase >= 0) & (pdist <= 1)
        self._pending_cnt = np.where(
            agree, self._pending_cnt + 1, np.where(usable, 1, 0))
        self._pending_phase = np.where(usable, phases, -1)

        repeated = self._pending_cnt >= 2
        single_shot = confs >= cfg.aided_sync_single_sigma
        # a 1-epoch disagreement is within the split-edge ambiguity of
        # the histogram — don't churn the grid over it
        dist = np.minimum((phases - grid_now) % cib,
                          (grid_now - phases) % cib)
        wrong_grid = sync_last & (dist > 1) & repeated
        fresh = ~sync_last & (
            repeated | (single_shot & (confs >= cfg.aided_sync_min_sigma))
        )
        engage = fresh | wrong_grid

        # Health check: a synced channel that is really tracking shows
        # its bit boundary in the histogram.  Persistently low
        # confidence while synced = wrong grid or carrier NCO (e.g. a
        # random-walk excursion of the run-time counters declared sync
        # on a bad boundary and grid-locking froze it) — de-sync it so
        # the next confident window can redo the engagement.
        if len(self._aided_low_conf) != n_chan:
            self._aided_low_conf = np.zeros(n_chan, int)
        low = sync_last & (confs < cfg.aided_sync_unhealthy_sigma)
        self._aided_low_conf = np.where(low, self._aided_low_conf + 1, 0)
        unhealthy = (
            self._aided_low_conf >= cfg.aided_sync_unhealthy_windows
        ) & ~engage

        if engage.any() or unhealthy.any():
            # Re-anchor the carrier NCO from the RAW block samples: the
            # pre-engage per-epoch loop wanders tens of Hz at low C/N0
            # (beyond the coherent loop's pull range), and a tracking
            # Costas keeps the prompts near the real axis, so only a
            # code-wiped measurement can see the NCO's frequency error.
            # All channels refine in ONE device program; only the (C,)
            # Doppler vector is read back (refine_doppler_device).
            from ..acquire.engine import refine_doppler_device

            span = min(512, n_epochs)
            prns = [ch.prn for ch in self.channels]
            if len(prns) < n_chan:
                # mesh ghost padding repeats channel 0
                # (MeshReceiver.start_tracking)
                prns = prns + [prns[0]] * (n_chan - len(prns))
            table = jnp.asarray(ca_table_bipolar(prns[:n_chan]))
            dops = np.asarray(self.track_state.doppler_hz)
            refined = np.asarray(refine_doppler_device(
                epochs[:span], table,
                jnp.asarray(cp0, jnp.float32),
                jnp.asarray(dops, jnp.float32), cfg.plan,
            ))
            acted_mask = engage | unhealthy
            new_dops = np.where(acted_mask[: len(dops)], refined, dops)
            if engage.any():
                self.track_state = engage_bit_sync(
                    self.track_state, phases,
                    self.epoch_cursor + n_epochs, cib, engage,
                )
            if unhealthy.any():
                un = jnp.asarray(unhealthy)
                i32z = jnp.zeros_like(self.track_state.right_period_cnt)
                self.track_state = self.track_state._replace(
                    period_sync_ok=jnp.where(
                        un, False, self.track_state.period_sync_ok),
                    right_period_cnt=jnp.where(
                        un, i32z, self.track_state.right_period_cnt),
                )
            self.track_state = self.track_state._replace(
                doppler_hz=jnp.asarray(new_dops, jnp.float32)
            )
            acted = engage | unhealthy
            self._aided_low_conf = np.where(
                acted, 0, self._aided_low_conf)
            self._pending_cnt = np.where(engage, 0, self._pending_cnt)
            self._pending_phase = np.where(engage, -1, self._pending_phase)

    def _consume_outputs(self, outs, n_epochs: int) -> None:
        """Host side: bits → framers → subframes → ephemeris; solve."""
        cfg = self.config
        bit_ready = np.asarray(outs.bit_ready)
        bit_value = np.asarray(outs.bit_value)
        bit_epoch = np.asarray(outs.bit_epoch)
        snr = np.asarray(outs.snr_db)
        dop = np.asarray(outs.doppler_hz)
        cp = np.asarray(outs.code_phase_chips)
        ip = np.asarray(outs.ip)
        qp = np.asarray(outs.qp)

        for c, ch in enumerate(self.channels):
            events = np.nonzero(bit_ready[:, c])[0]
            for t in events:
                self._push_channel_bit(
                    ch, int(bit_value[t, c]), int(bit_epoch[t, c])
                )
            ch.snr_db = float(snr[-1, c])
            sync_c = np.asarray(outs.period_sync_ok)[:, c]
            ch.bit_synced = bool(sync_c[-1])
            # lock-time ledger (DF402): any un-synced epoch inside the
            # block restarts the continuous-lock clock
            if not ch.bit_synced:
                if ch.lock_start_ms >= 0:
                    ch.lock_start_ms = -1
                    ch.rtcm_phase_align_m = 0.0
            else:
                unsync = np.nonzero(~sync_c)[0]
                if unsync.size:
                    ch.lock_start_ms = self.epoch_cursor + int(unsync[-1]) + 1
                    ch.rtcm_phase_align_m = 0.0
                elif ch.lock_start_ms < 0:
                    ch.lock_start_ms = self.epoch_cursor
            # exclude nav-bit-edge epochs (attenuated prompts corrupt
            # the moments; the edge sits at the bit boundary epoch and
            # its predecessor)
            br_c = bit_ready[:, c]
            # non-wrapping shift: np.roll would wrap the final epoch's
            # flag onto index 0, wrongly excluding the block's first
            # epoch instead of the last edge's predecessor
            clean = ~(br_c | np.concatenate([br_c[1:], [False]]))
            ch.cn0_dbhz = _m2m4_cn0(ip[clean, c], qp[clean, c])
            if ch.cn0_dbhz >= cfg.cn0_floor_dbhz:
                ch.last_healthy_ms = self.epoch_cursor + n_epochs
            ch.doppler_hz = float(dop[-1, c])
            # integrated Doppler = carrier-phase observable (cycles);
            # float64 host accumulation avoids f32 drift
            ch.carrier_cycles += float(
                np.sum(dop[:, c].astype(np.float64)) * 1e-3
            )
            ch.code_phase_chips = float(cp[-1, c])
            if cfg.enable_code_filter:
                ch.code_phase_chips = self._filtered_code_phase(
                    cp[:, c], ch.doppler_hz
                )

        self._run_cadences(self.epoch_cursor + n_epochs)

    def _push_channel_bit(self, ch: ChannelStatus, value: int,
                          epoch: int) -> None:
        """One demodulated nav bit → framer → subframe/ephemeris/ledger
        (shared by the full-readback and digest paths)."""
        push_channel_bit(ch, value, epoch, self.config.track.codes_in_bit)

    def _consume_digest(self, d, n_epochs: int) -> None:
        """Host side of the device-resident loop: the BlockDigest
        (already pulled to numpy by the caller — the only device→host
        transfer, runtime.digest).

        The per-channel host cost bounds the SYSTEM at high channel
        counts, so the hot loop works
        on plain Python lists: one .tolist() per leaf replaces hundreds
        of thousands of numpy scalar __getitem__/int() conversions per
        block (~2x the whole host path at 256 channels)."""
        from .digest import cn0_from_moments

        cfg = self.config
        bit_count = d.bit_count.tolist()
        bit_value = d.bit_value.T.tolist()      # (C, K) int lists
        bit_epoch = d.bit_epoch.T.tolist()
        snr_db = d.snr_db.tolist()
        sync_ok = d.period_sync_ok.tolist()
        any_loss = d.sync_any_loss.tolist()
        last_unsync = d.last_unsync_epoch.tolist()
        cn0_m2 = d.cn0_m2.tolist()
        cn0_m4 = d.cn0_m4.tolist()
        cn0_n = d.cn0_n.tolist()
        doppler = d.doppler_hz.tolist()
        doppler_sum = d.doppler_sum.tolist()
        cp = (d.code_phase_filtered if cfg.enable_code_filter
              else d.code_phase_chips).tolist()
        for c, ch in enumerate(self.channels):
            bv, be = bit_value[c], bit_epoch[c]
            for k in range(bit_count[c]):
                self._push_channel_bit(ch, bv[k], be[k])
            ch.snr_db = snr_db[c]
            ch.bit_synced = sync_ok[c]
            if not ch.bit_synced:
                if ch.lock_start_ms >= 0:
                    ch.lock_start_ms = -1
                    ch.rtcm_phase_align_m = 0.0
            else:
                if any_loss[c]:
                    ch.lock_start_ms = (
                        self.epoch_cursor + last_unsync[c] + 1
                    )
                    ch.rtcm_phase_align_m = 0.0
                elif ch.lock_start_ms < 0:
                    ch.lock_start_ms = self.epoch_cursor
            ch.cn0_dbhz = cn0_from_moments(cn0_m2[c], cn0_m4[c], cn0_n[c])
            if ch.cn0_dbhz >= cfg.cn0_floor_dbhz:
                ch.last_healthy_ms = self.epoch_cursor + n_epochs
            ch.doppler_hz = doppler[c]
            ch.carrier_cycles += doppler_sum[c] * 1e-3
            ch.code_phase_chips = cp[c]
        self._run_cadences(self.epoch_cursor + n_epochs)

    def _update_half_cycle(self, ch: ChannelStatus) -> None:
        """Resolve the Costas half-cycle ambiguity from nav polarity.

        A Costas loop locks indistinguishably at 0 or pi; once the
        framer pins the bit polarity (preamble found), an inverted
        polarity means the carrier is pi out of phase — the true phase
        observable is the measured one plus half a cycle.  The firmware
        never forms a carrier observable at all (sdrobs2obsd leaves
        obsd L=0, obs_publish.c), so this exists only here.  A
        polarity CHANGE (half-cycle slip re-detected the other way)
        breaks carrier continuity: reset the Hatch filter and the RTCM
        phaserange alignment."""
        if not ch.framer.polarity_found:
            ch.half_cycle_known = False   # ambiguous until re-pinned
            return
        hc = -1 if ch.framer.inv_polarity else 1
        if hc != ch.half_cycle:
            if ch.half_cycle != 0:        # a real slip, not first pin
                ch.hatch = HatchState()
                ch.rtcm_phase_align_m = 0.0
                ch.lock_start_ms = -1     # DF402: phase discontinuity
            ch.half_cycle = hc
        ch.half_cycle_known = True

    def _L_cycles(self, ch: ChannelStatus) -> float:
        """Half-cycle-corrected carrier-phase observable (cycles)."""
        return ch.carrier_cycles + (0.5 if ch.half_cycle < 0 else 0.0)

    def _relative_L(self, ready: List[ChannelStatus]) -> dict:
        """Carrier phase re-based to the pseudorange time base (cycles).

        form_observations pins the reference satellite's pseudorange to
        68.802 ms (the firmware's relative convention, gps_master.c:199
        -201): the receiver clock realization is DEFINED by the
        reference channel's range.  A raw integrated-Doppler carrier
        uses each channel's own range as its base, so code-minus-
        carrier would drift at the reference channel's full range rate
        (hundreds of m/s) — breaking both the Hatch filter (constant
        resets past reset_threshold_m) and RTCM phaserange continuity.
        Subtracting a sticky reference channel's L puts the carrier on
        the SAME clock realization as P; the SAME sticky PRN is pinned
        into form_observations (ref_prn) so code and carrier share one
        base — with independent references the reference sat's P is
        frozen while its L drifts at the differential Doppler.  When
        the reference channel leaves the ready set, the clock base
        jumps: phase alignments and Hatch histories restart."""
        by_prn = {ch.prn: ch for ch in ready}
        if self._phase_ref_prn not in by_prn:
            is_switch = self._phase_ref_prn != 0
            # earliest boundary arrival = closest satellite, the
            # firmware's reference convention (gps_master.c:180-184),
            # sticky from here on
            self._phase_ref_prn = min(
                ready,
                key=lambda c: boundary_arrival_ms(
                    c.subframe_time_ms, c.code_phase_chips)
                - c.subframe_tow_s * 1000.0,
            ).prn
            if is_switch:
                # every reported phaserange jumps with the new clock
                # base: restart alignments and signal the
                # discontinuity via DF402 (initial selection emits
                # nothing yet — no discontinuity to signal)
                for ch in self.channels:
                    ch.rtcm_phase_align_m = 0.0
                    ch.hatch = HatchState()
                    ch.lock_start_ms = -1
        ref_l = self._L_cycles(by_prn[self._phase_ref_prn])
        return {ch.prn: self._L_cycles(ch) - ref_l for ch in ready}

    def _run_cadences(self, end_ms: int) -> None:
        """PVT at the solve cadence (gps_master.c:392-425) and RTCM at
        its own (gps_master_transmit_obs, gps_master.c:430-456)."""
        cfg = self.config
        for ch in self.channels:
            self._update_half_cycle(ch)
        if (
            cfg.enable_position
            and end_ms - self._last_solve_ms >= cfg.solve_period_ms
        ):
            self._last_solve_ms = end_ms
            self._try_solve(end_ms - 1, None)
        if (
            cfg.enable_rtcm
            and end_ms - self._last_rtcm_ms >= cfg.rtcm_period_ms
        ):
            self._last_rtcm_ms = end_ms
            self._emit_rtcm(end_ms - 1)

    @staticmethod
    def _dejitter_boundary(ch: ChannelStatus, boundary: int,
                           cib: int) -> int:
        """See module-level :func:`dejitter_boundary`."""
        return dejitter_boundary(ch, boundary, cib)

    def _filtered_code_phase(self, cp_hist: np.ndarray,
                             doppler_hz: float) -> float:
        """Code-phase smoothing: drift-detrended average of the last K
        epochs, referenced to the final epoch.

        The capability of the firmware's code filter
        (gps_master_filter_code_phase, gps_master.c:332-388; 100
        measurements, config.h:38) — but detrending with the known code
        Doppler instead of halving the window timestamp, so no wrap
        special-casing is needed."""
        from ..config import CODE_LENGTH, FREQ_L1_HZ

        k = min(self.config.code_filter_len, len(cp_hist))
        seg = np.asarray(cp_hist[-k:], dtype=np.float64)
        drift = CODE_LENGTH * doppler_hz / FREQ_L1_HZ   # chips per epoch
        expected = drift * (np.arange(k) - (k - 1))
        resid = seg - seg[-1] - expected
        resid = (resid + CODE_LENGTH / 2) % CODE_LENGTH - CODE_LENGTH / 2
        return float((seg[-1] + resid.mean()) % CODE_LENGTH)

    def _try_solve(self, meas_epoch_ms: int, code_phases) -> None:
        cfg = self.config
        ready = [ch for ch in self.channels if ch.eph.has_full_set
                 and ch.subframe_time_ms > 0]
        if len(ready) < 4:
            return
        chobs = [
            ChannelObservables(
                prn=ch.prn,
                subframe_time_ms=ch.subframe_time_ms + ch.grid_bias_ms,
                tow_s=ch.subframe_tow_s,
                week=ch.eph.week,
                code_phase_chips=ch.code_phase_chips,
                doppler_hz=ch.doppler_hz,
                snr_db=ch.snr_db,
            )
            for ch in ready
        ]
        # sticky reference first: the same PRN pins both the carrier
        # re-basing and the pseudorange convention below
        rel_l = self._relative_L(ready)
        obs = form_observations(chobs, meas_epoch_ms,
                                ref_prn=self._phase_ref_prn)
        if obs is None:
            return
        # carrier smoothing (Hatch): integrated Doppler propagates the
        # pseudorange between solve epochs, averaging code noise down
        for o, ch in zip(obs, ready):
            o.L = rel_l[ch.prn]
            o.P = ch.hatch.update(o.P, o.L, epoch_ms=meas_epoch_ms)
        eph_map = {ch.prn: ch.eph for ch in ready}
        x0 = self.solutions[-1].rr if self.solutions else None
        # solver stage carries the firmware's budget-alarm role
        # (solving.c:119-138, 900 us per 1 ms slice; here: one full
        # solve within its 500 ms cadence period)
        with self.profiler.stage(
            "solve", budget_s=cfg.solve_period_ms * 1e-3
        ).time():
            sol = pntpos(obs, eph_map, x0=x0,
                         raim_threshold_m=cfg.raim_threshold_m)
        if not sol.ok:
            return
        # valsol-style sanity gate (the firmware's commented-out
        # residual check, solving.c:436-439): a single channel with a
        # wrong integer-ms boundary produces a CONVERGED solution
        # hundreds of km off with km-scale residuals; with <6 sats RAIM
        # cannot identify it, so reject the epoch instead.
        if cfg.max_resid_rms_m > 0 and sol.residuals is not None:
            rms = float(np.sqrt(np.mean(sol.residuals ** 2)))
            if rms > cfg.max_resid_rms_m:
                return
        # physical plausibility gate + single-channel grid-fault
        # identification (the 4-satellite boundary-integrity hole: a
        # wrong bit grid converges with ZERO residuals at 4 sats, so
        # only physics can catch it — solve.solution_plausible)
        from ..pvt.solve import identify_grid_fault, solution_plausible

        gates = dict(min_altitude_m=cfg.min_altitude_m,
                     max_altitude_m=cfg.max_altitude_m,
                     min_clock_bias_ms=cfg.min_clock_bias_ms,
                     max_clock_bias_ms=cfg.max_clock_bias_ms,
                     max_speed_mps=cfg.max_speed_mps)
        if cfg.min_altitude_m < cfg.max_altitude_m and not \
                solution_plausible(sol, **gates):
            if not cfg.grid_fault_search:
                return
            hit = identify_grid_fault(obs, eph_map, x0=x0, **gates)
            if hit is None:
                return                      # ambiguous: reject the epoch
            sol, idx, shift_ms = hit
            ch = ready[idx]
            ch.grid_bias_ms += shift_ms
            ch.grid_faults += 1
            ch.hatch = HatchState()         # history spans the fault
        self.solutions.append(sol)
        self.solution_epochs.append(meas_epoch_ms)

    def maybe_reacquire(self, recent_samples: np.ndarray) -> List[int]:
        """Background acquisition of standby PRNs on recent samples;
        detections join the live tracking state (late-rising satellites
        — the firmware's channel set is fixed at flash time).

        ``recent_samples`` must end at the current epoch cursor.  Returns
        the PRNs added.
        """
        cfg = self.config
        if not self.standby_channels:
            return []
        spe = cfg.plan.samples_per_epoch
        need = max(cfg.acq.noncoherent_epochs,
                   cfg.track.pre_track_epochs) * spe
        if len(recent_samples) < need:
            return []
        window = recent_samples[-need:]
        # search-state ledger (acquisition.c:217-224 semantics): start
        # the per-channel search clock; a channel failing for longer
        # than cfg.acq.timeout_ms discards its (possibly stale) Doppler
        # hint and restarts the clock, widening to a full-grid search.
        now = self.epoch_cursor
        for ch in self.standby_channels:
            if ch.acq_search_start_ms < 0:
                ch.acq_search_start_ms = now
            elif (cfg.acq.timeout_ms > 0
                  and now - ch.acq_search_start_ms > cfg.acq.timeout_ms):
                ch.acq_hint_hz = None
                ch.acq_search_start_ms = now
                ch.acq_timeouts += 1
                ch.state_name = "ACQ_TIMEOUT"
        hints = {}
        for prn, h in zip(cfg.prns, cfg.doppler_hints_hz or ()):
            if h is not None:
                hints[int(prn)] = float(h)
        for ch in self.standby_channels:
            if ch.acq_hint_hz is not None:
                hints[ch.prn] = float(ch.acq_hint_hz)
            elif ch.acq_timeouts > 0:
                hints.pop(ch.prn, None)     # timed out: full-grid search
        prns = [ch.prn for ch in self.standby_channels]
        results = acquire(window, prns, cfg.plan, cfg.acq,
                          doppler_hints_hz=hints or None)
        hits = [
            (ch, res)
            for ch, res in zip(self.standby_channels, results)
            if res.detected
        ]
        if not hits:
            return []
        from ..acquire.engine import refine_doppler_device

        new_prns = [ch.prn for ch, _ in hits]
        table_new = ca_table_bipolar(new_prns)
        e = min(32, len(window) // spe)
        fine_ep = jnp.asarray(
            window[: e * spe].reshape(e, spe), jnp.complex64)
        dopplers = np.asarray(refine_doppler_device(
            fine_ep, jnp.asarray(table_new),
            jnp.asarray([res.code_phase_chips for _, res in hits],
                        jnp.float32),
            jnp.asarray([res.doppler_hz for _, res in hits], jnp.float32),
            cfg.plan,
        )).astype(np.float64)
        phases = refine_code_phase(
            window,
            table_new,
            np.array([res.code_phase_chips for _, res in hits]),
            dopplers, cfg.plan, cfg.track,
        )
        # the acquisition window ended at the cursor; the refined code
        # phase refers to the window start — advance to the cursor
        win_epochs = need // spe
        adv = (win_epochs * spe * cfg.plan.chips_per_sample
               * (1.0 + dopplers / 1.57542e9))
        phases = (phases + adv) % 1023.0
        new_state = init_state(len(hits), phases, dopplers,
                               start_epoch=self.epoch_cursor,
                               window=cfg.track.pll_check_window)
        self.track_state = concat_states(self.track_state, new_state)
        self.code_table = jnp.concatenate(
            [self.code_table, jnp.asarray(table_new)], axis=0
        )
        for ch, res in hits:
            ch.acq = res
            ch.state_name = "TRACKING"
            ch.acq_search_start_ms = -1
            ch.last_healthy_ms = self.epoch_cursor
            self.channels.append(ch)
            self.standby_channels.remove(ch)
        return new_prns

    def drop_dead_channels(self, cn0_floor_dbhz: float = None,
                           grace_ms: int = None) -> List[int]:
        """Demote channels that have been unhealthy (measured C/N0
        below ``cn0_floor_dbhz``) for longer than ``grace_ms`` to
        standby, removing them from the live tracking state.  They
        become candidates for background re-acquisition.

        Staleness of a single health signal (the per-block C/N0
        estimate refreshing ``last_healthy_ms``) covers every failure
        mode uniformly: C/N0 collapsed to a small positive value, the
        M2M4 estimator returning 0.0 on noise — regardless of what the
        I/Q-ratio SNR happens to read — and a channel that once decoded
        bits and then died.  (The previous value-at-this-instant
        heuristic left the last two tracking garbage forever.)  The
        firmware never demotes at all (its false-lock watchdog only
        kicks the carrier, tracking.c:306-326).
        """
        import jax

        cfg = self.config
        floor = (cfg.cn0_floor_dbhz if cn0_floor_dbhz is None
                 else cn0_floor_dbhz)
        grace = cfg.demote_grace_ms if grace_ms is None else grace_ms
        dead = []
        for c, ch in enumerate(self.channels):
            # an explicit floor above the configured one can demote a
            # channel whose ledger is fresh at the configured floor
            if ch.cn0_dbhz >= floor:
                continue
            if self.epoch_cursor - ch.last_healthy_ms > grace:
                dead.append(c)
        if not dead:
            return []
        keep = np.array(
            [c for c in range(len(self.channels)) if c not in dead],
            dtype=np.int32,
        )
        if len(keep) == 0:
            return []          # never drop the last channels
        keep_j = jnp.asarray(keep)
        self.track_state = jax.tree.map(
            lambda x: x[keep_j], self.track_state
        )
        self.code_table = self.code_table[keep_j]
        dropped = []
        for c in sorted(dead, reverse=True):
            ch = self.channels.pop(c)
            ch.state_name = "LOST"
            ch.framer = self._new_framer()
            ch.subframe_time_ms = 0
            ch.half_cycle = 0
            ch.half_cycle_known = False
            # last tracked Doppler becomes the re-acquisition hint
            # (warm-reset capability, gps_master.c:498-506)
            if ch.bit_count > 0:
                ch.acq_hint_hz = ch.doppler_hz
            ch.acq_search_start_ms = -1
            self.standby_channels.append(ch)
            dropped.append(ch.prn)
        return dropped

    def _emit_rtcm(self, meas_epoch_ms: int) -> None:
        """Queue RTCM3 frames: eph 1019 for newly complete ephemerides
        (mask cleared after send, gps_master.c:441-446) + MSM5 obs."""
        from ..io.rtcm3 import MsmObs, encode_1019, encode_msm, frame

        for ch in self.channels:
            if (ch.eph.received_mask & 0x7) == 0x7:
                ch.eph.received_mask &= ~0x7
                self.rtcm_frames.append(frame(encode_1019(ch.eph)))
        ready = [ch for ch in self.channels
                 if ch.eph.has_full_set and ch.subframe_time_ms > 0]
        if len(ready) < 1:
            return
        chobs = [
            ChannelObservables(
                prn=ch.prn,
                subframe_time_ms=ch.subframe_time_ms + ch.grid_bias_ms,
                tow_s=ch.subframe_tow_s, week=ch.eph.week,
                code_phase_chips=ch.code_phase_chips,
                doppler_hz=ch.doppler_hz, snr_db=ch.snr_db,
            )
            for ch in ready
        ]
        rel_l = self._relative_L(ready)
        obs = form_observations(chobs, meas_epoch_ms,
                                ref_prn=self._phase_ref_prn)
        if not obs:
            return
        from ..pvt.observables import LAMBDA_L1_M

        msm = []
        for o, ch in zip(obs, ready):
            # carrier observable: form_observations has no carrier
            # state, so attach the channel's half-cycle-corrected,
            # clock-rebased phase here — without it the phaserange
            # would freeze at its first-emission alignment value
            o.L = rel_l[ch.prn]
            # carrier-smoothed pseudorange: raw DLL code noise is
            # meters-scale between emissions; the Hatch filter (the
            # firmware's code-filter role, gps_master.c:332-388, but
            # carrier-aided) keeps the emitted P code-carrier
            # consistent.  Updates here AND at the solve cadence each
            # fold one (P, L) measurement; HatchState.update is
            # idempotent per epoch, so a coincident solve+RTCM epoch
            # folds once (tests/test_runtime.py pins this).
            o.P = ch.hatch.update(o.P, o.L, epoch_ms=meas_epoch_ms)
            # phaserange: ambiguity initialized so it aligns with the
            # pseudorange at first emission, carrier-continuous after.
            # Positive Doppler = closing range (HatchState.update), so
            # the range-domain phase observable DECREASES as L grows.
            if ch.rtcm_phase_align_m == 0.0:
                ch.rtcm_phase_align_m = o.P + LAMBDA_L1_M * o.L
            lock_s = (
                (meas_epoch_ms - ch.lock_start_ms) / 1000.0
                if ch.lock_start_ms >= 0 else 0.0
            )
            msm.append(MsmObs(
                sat=o.sat, pseudorange_m=o.P, doppler_hz=o.D,
                cn0_dbhz=max(o.snr + 30.0, 0.0),
                lock_time_s=lock_s,
                phaserange_m=ch.rtcm_phase_align_m - LAMBDA_L1_M * o.L,
                half_cycle_ambiguous=not ch.half_cycle_known,
            ))
        from ..pvt.gpstime import time2gpst

        tow_s, _ = time2gpst(obs[0].time)
        self.rtcm_frames.append(frame(encode_msm(1075, tow_s, msm)))

    def warm_reset(self, samples: np.ndarray) -> None:
        """Operator warm reset: drop tracking/nav state but keep each
        channel's learned Doppler as the new acquisition hint
        (gps_master_reset_to_aqc_start, gps_master.c:490-510; triggered
        by the UP button via keys_controlling.c in the firmware)."""
        hints = {
            ch.prn: ch.doppler_hz
            for ch in self.channels
            if ch.framer.words_decoded > 1
        }
        for ch in self.channels:
            ch.framer = self._new_framer()
            ch.subframe_time_ms = 0
            ch.subframe_tow_s = 0.0
            ch.subframe_count = 0
            ch.bit_count = 0
            ch.state_name = "IDLE"
            ch.half_cycle = 0
            ch.half_cycle_known = False
        self.track_state = None
        self.acquire_all(samples, extra_hints=hints)
        self.start_tracking(samples, start_epoch=self.epoch_cursor)

    # -- top level --------------------------------------------------------

    def run(self, samples: np.ndarray,
            status_callback=None) -> ReceiverReport:
        """Process a whole capture end-to-end."""
        cfg = self.config
        spe = cfg.plan.samples_per_epoch
        self._status_cb = status_callback

        self.acquire_all(samples)
        acq_epochs = cfg.acq.noncoherent_epochs
        self.start_tracking(samples[acq_epochs * spe:],
                            start_epoch=acq_epochs)
        self.epoch_cursor = acq_epochs

        block = cfg.track_block_epochs * spe
        pos = acq_epochs * spe
        while pos + spe <= len(samples):
            chunk = samples[pos: pos + block]
            if len(chunk) < spe:
                break
            self.process_block(chunk)
            pos += (len(chunk) // spe) * spe
            if (
                cfg.reacquire_period_ms
                and self.epoch_cursor - self._last_reacq_ms
                >= cfg.reacquire_period_ms
            ):
                self._last_reacq_ms = self.epoch_cursor
                self.drop_dead_channels()
                if self.standby_channels:
                    self.maybe_reacquire(samples[:pos])
            if status_callback is not None:
                status_callback(self)
        return ReceiverReport(
            channels=self.channels,
            solutions=self.solutions,
            solution_epochs_ms=self.solution_epochs,
            epochs_processed=self.epoch_cursor,
        )
