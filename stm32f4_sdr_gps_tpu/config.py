"""Typed configuration for the JAX GPS L1 C/A receiver.

This replaces the reference firmware's compile-time macro header
(``/root/reference/Firmware/project_main/config.h``) with frozen dataclasses.
Numeric defaults (loop gains, acquisition grid, thresholds, cadences) are
inherited from the firmware so the two pipelines are comparable:

* signal plan constants ............ config.h:23-28
* acquisition grid ................. config.h:41-48
* loop-filter gains ................ config.h:61-71
* nav/bit constants ................ nav_data.c:15-22, tracking.c:14-26
* build week ....................... config.h:73
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

# Physical constants (IS-GPS-200 / WGS84).
CLIGHT = 299_792_458.0        # speed of light, m/s          (rtk_common.h:43)
FREQ_L1_HZ = 1.57542e9        # L1 carrier, Hz               (rtk_common.h:44)
CODE_RATE_HZ = 1.023e6        # C/A chipping rate, chips/s
CODE_LENGTH = 1023            # chips per C/A code period    (config.h:28)
CODE_PERIOD_S = CODE_LENGTH / CODE_RATE_HZ   # 1 ms
CODES_IN_BIT = 20             # C/A periods per nav bit      (nav_data.c:15)
BIT_RATE_HZ = 50.0
WORDS_IN_SUBFRAME = 10        # nav_data.c:17
WORD_LENGTH_BITS = 30         # gps_misc.h:11
SUBFRAME_DURATION_MS = 6000   # nav_data.c:19
PREAMBLE_BITS = (1, 0, 0, 0, 1, 0, 1, 1)  # L1 C/A TLM preamble (nav_data.c:26)

# GPS time origin.
UNIX2GPS_S = 315_964_800      # Unix→GPS epoch offset, s (rtklib_common.c:6)
GPS_UTC_OFFSET_S = 18         # gps_misc.h:15
GPS_BUILD_WEEK = 2290         # week rollover pin (config.h:73)

# Nominal single-point offset used for relative pseudorange formation.
GPS_OFFSET_TIME_MS = 68.802   # gps_master.c:31


@dataclass(frozen=True)
class SignalPlan:
    """Sampling plan for one IQ capture.

    The default is *complex baseband* IQ at 2.046 MHz
    (2 samples/chip).  The reference firmware's plan (1-bit real samples at
    16.368 MHz with a 4.092 MHz IF, config.h:23-26) is expressed with the
    same dataclass and converted to the baseband plan by
    :mod:`stm32f4_sdr_gps_tpu.signal.capture`.
    """

    sample_rate_hz: float = 2.046e6
    if_freq_hz: float = 0.0          # 0 => complex baseband
    complex_input: bool = True       # False => real-sampled (IF) input
    quantize_bits: int = 0           # 0 => float samples; 1 => sign-only

    @property
    def samples_per_epoch(self) -> int:
        """Samples in one 1 ms C/A code period."""
        n = self.sample_rate_hz * CODE_PERIOD_S
        n_int = int(round(n))
        if abs(n - n_int) > 1e-6:
            raise ValueError(
                f"sample_rate_hz={self.sample_rate_hz} is not an integer "
                "number of samples per 1 ms code period"
            )
        return n_int

    @property
    def samples_per_chip(self) -> float:
        return self.sample_rate_hz / CODE_RATE_HZ

    @property
    def chips_per_sample(self) -> float:
        return CODE_RATE_HZ / self.sample_rate_hz


#: Default plan: complex baseband, 2 samples/chip.
BASEBAND_PLAN = SignalPlan()

#: The reference front-end plan: MAX2769 1-bit real sign stream.
#: config.h:23-26, signal_capture.c:9-11.
REFERENCE_PLAN = SignalPlan(
    sample_rate_hz=16.368e6,
    if_freq_hz=4.092e6,
    complex_input=False,
    quantize_bits=1,
)


@dataclass(frozen=True)
class AcqConfig:
    """Acquisition engine configuration.

    The grid matches the firmware (config.h:41-44): +/-7 kHz in 500 Hz
    steps.  The detector is peak/second-peak on FFT circular correlation
    instead of serial histogram voting; an epoch-voting mode
    compatible with the firmware's histogram logic also exists
    (acquisition.c:196-416).
    """

    doppler_span_hz: float = 7000.0
    doppler_step_hz: float = 500.0
    noncoherent_epochs: int = 10      # epochs summed non-coherently
    coherent_epochs: int = 1          # epochs summed coherently per NC block
    # Nav-bit-edge hypotheses for long coherent spans: the coherent
    # block start is tried at this many offsets across one block and the
    # per-block-normalized powers are max-combined, so at least one
    # hypothesis aligns the blocks with the (unknown) 20 ms bit grid.
    # 1 = no hypotheses (spans must stay well under a bit).
    edge_hypotheses: int = 1
    detect_ratio: float = 1.5         # peak / second-peak acceptance
    exclude_chips: float = 1.5        # exclusion zone around peak for 2nd peak
    # Histogram-vote compat mode (acquisition.c thresholds):
    hist_ratio: float = 3.2           # acquisition.c:260
    freq_hist_min_votes: int = 3      # acquisition.c:382
    freq_hist_ratio: float = 1.7      # acquisition.c:402
    timeout_ms: int = 120_000         # acquisition.c:13
    # Evaluate the acquisition cube with dense (S, S) matmul DFTs on the
    # tensor cores instead of FFT HLOs (S=2046 = 2*3*11*31 is not a
    # power of two).  Same outputs to ~1e-5 relative at "highest"
    # (ops.correlate.matmul_circular_correlate).
    use_matmul_dft: bool = False
    # Matmul precision of the DFT contractions.  "default" lets XLA pick
    # the fastest f32 contraction: on an H100 that is TF32 (10-bit
    # mantissa inputs, f32 accumulation); "highest" is full f32.  Input
    # rounding of ~1e-3 of the per-product magnitude is averaged by the
    # noncoherent integration: detection statistics, peak ratios and
    # sub-sample interpolation agree with f32 to ~1e-3 (pinned by the
    # reduced-precision emulation test in tests/test_acquisition.py),
    # far inside the detect_ratio margins.  The CPU backend computes
    # f32 either way.  Speed of either on the card: not measured.
    dft_precision: str = "default"

    @property
    def doppler_bins_hz(self) -> tuple:
        n = int(round(2 * self.doppler_span_hz / self.doppler_step_hz)) + 1
        return tuple(
            -self.doppler_span_hz + i * self.doppler_step_hz for i in range(n)
        )


@dataclass(frozen=True)
class TrackConfig:
    """Tracking loop configuration.

    Gain constants come from config.h:61-71.  The firmware expresses its
    DLL state in 1/16-chip units (tracking.c:23 GPS_FINE_RATIO applied to
    half-chip steps); we track code phase in *chips*, so DLL gains are
    divided by 16 at the update site.  The firmware services each channel
    4 of every 17 epochs (TDM) and closes the PLL once per 17 ms slot 0
    (tracking.c:175-209); our channels run every epoch, so per-epoch gain
    scaling keeps an equivalent loop bandwidth.
    """

    epl_spacing_chips: float = 0.5    # E/P/L spacing (tracking.c:122-138)
    dll_c1: float = 1.0               # TRACKING_DLL1_C1
    dll_c2: float = 300.0             # TRACKING_DLL1_C2
    fine_ratio: float = 16.0          # reference fine units per chip
    pll_wide_c1: float = 4.0          # TRACKING_PLL1_* (before bit sync)
    pll_wide_c2: float = 3000.0
    pll_narrow_c1: float = 8.0        # TRACKING_PLL2_* (after bit sync)
    pll_narrow_c2: float = 5000.0
    fll_c1: float = 200.0             # TRACKING_FLL1_*
    fll_c2: float = 2000.0
    dt_s: float = 1e-3                # epoch period (tracking.c:194)
    # Loop cadence in epochs. The reference applies PLL once per 17 ms
    # superframe; running every epoch with the same per-step gains is the
    # default here (higher bandwidth, stable at 1 kHz updates).
    pll_scale: float = 1.0 / 4.0      # per-epoch gain scale vs reference slot cadence
    fll_scale: float = 1.0 / 4.0
    snr_window_epochs: int = 200      # GPS_SNR_CALC_LENGTH (tracking.c:26)
    # False-lock watchdog (tracking.c:261-327):
    pll_check_window: int = 4         # TRACKING_CH_LENGTH window
    pll_bad_state_threshold: int = 80  # PLL_BAD_STATE_DETECTION_THRESHOLD
    # Bit sync (nav_data.c:105-126):
    bit_sync_up: int = 8              # sync declared above this count
    bit_sync_down: int = 3            # sync lost below this count
    bit_sync_max: int = 10
    # Grid-locked coherent bit extraction.  The firmware's bit sync
    # (nav_data.c:46-138) rebases the bit boundary on EVERY prompt sign
    # flip, so at low C/N0 noise flips fragment bits (a window never
    # even contains mixed signs — majority voting is vacuous there).
    # With this flag, once period sync is declared the bit grid is
    # frozen (flips no longer rebase the boundary or feed the sync
    # counters) and each bit is decided by the sign of the coherent
    # prompt-I sum over the full bit — the entire 20 ms integration
    # gain reaches the decision.  Sync recovery from a genuine slip is
    # then the job of the C/N0 watchdog / reacquisition, not the flip
    # tracker.  Off by default for firmware-parity bit streams.
    coherent_bit_vote: bool = False
    # 20 ms coherent PLL: once period sync is declared, the Costas loop
    # closes on the coherent prompt sums over each whole nav bit (one
    # update per bit at the boundary, per-epoch PLL/FLL frozen) —
    # +10*log10(codes_in_bit) dB of discriminator SNR, extending phase
    # hold far below the per-epoch floor.  This is the firmware's own
    # design cadence: it closes its PLL once per 17 ms superframe slot
    # (tracking.c:175-209), so the narrow gains apply at ~full scale.
    # Implies the grid-locked bit extraction above.  The per-epoch
    # false-lock watchdog is frozen while synced (its sign-transition
    # statistic is meaningless at the C/N0 this mode targets).
    #
    # The per-bit gains are a proper discrete design for the 50 Hz
    # update rate (NOT the firmware constants, which assume per-epoch
    # discriminators): with the discriminator in half-cycles,
    # c1 = zeta*omega_n, c2 = omega_n^2/2.  Default omega_n = 6 rad/s,
    # zeta = 0.9 — measured best from a bandwidth sweep at 25-32 dBHz
    # (0/1499 bit errors at 28 dBHz, 27/1499 at 26; wider settings slip
    # half-cycles).  Steady-state lag at the GPS-orbit worst-case
    # 0.5 Hz/s Doppler rate is 0.014 cycles — narrow is safe for a
    # terrestrial receiver.
    coherent_pll: bool = False
    pll_bit_c1: float = 5.4
    pll_bit_c2: float = 18.0
    pll_bit_scale: float = 1.0        # gain scale for the per-bit update
    # Extended multi-bit coherent PLL (data wipeoff): with
    # pll_ext_bits = K > 1 (requires coherent_pll), each completed bit's
    # coherent prompt vector is sign-decided (the bit decision IS the
    # data wipeoff — at the C/N0 this targets, per-bit Eb/N0 >= ~8 dB
    # keeps decision errors < 1e-3) and accumulated; the Costas loop
    # closes on the K-bit coherent sum at K*20 ms cadence.  Coherent
    # integration grows K-fold (discriminator sigma ~ 1/sqrt(2*CN0*KT)),
    # extending phase hold ~10*log10(K)/2 dB below the per-bit floor.
    # Gains follow the pll_bit design rule (c1 = zeta*omega_n,
    # c2 = omega_n^2/2) at a narrower omega_n matched to the slower
    # update: omega_n = 2.2 rad/s, zeta = 0.9 measured best at
    # 23-26 dBHz with K = 5.
    pll_ext_bits: int = 1
    pll_ext_c1: float = 2.0
    pll_ext_c2: float = 2.42
    pll_ext_scale: float = 1.0
    codes_in_bit: int = CODES_IN_BIT  # C/A periods per nav bit (20; test
    #                                   configs may compress time)
    # Pre-track refinement zone, half-chips (tracking.c:17)
    pre_track_zone_halfchips: int = 30
    pre_track_epochs: int = 20
    emit_correlators: bool = False    # include E/L outputs (diagnostics)


#: Deep-acquisition preset: 4 ms coherent spans with a Doppler grid fine
#: enough for the coherent bandwidth (bin <= 1/(2*T_coh)), 60 epochs of
#: integration — detects ~3 dB below the firmware-grid default
#: (~31 dBHz vs ~34 dBHz).  Coherent spans assume bit edges are unknown,
#: so spans longer than ~5 epochs risk straddling a nav-bit flip.
DEEP_ACQ = AcqConfig(
    noncoherent_epochs=60,
    coherent_epochs=4,
    doppler_step_hz=100.0,
)

#: Full-bit coherent acquisition: 20 ms coherent spans with 10 bit-edge
#: hypotheses (one aligns the blocks to the unknown bit grid) and a
#: matched 25 Hz Doppler grid.  ~10x the compute of DEEP_ACQ per
#: hypothesis x10 hypotheses; detects a few dB deeper — pair with
#: COHERENT_TRACK for the lowest-C/N0 cold starts.
ULTRA_ACQ = AcqConfig(
    noncoherent_epochs=120,
    coherent_epochs=20,
    doppler_step_hz=25.0,
    edge_hypotheses=10,
)

#: Narrow-bandwidth loop preset for weak signals: holds lock down to
#: ~29 dBHz (the firmware-gain default degrades below ~32 dBHz).  The
#: longer time constants assume low platform dynamics.
WEAK_SIGNAL_TRACK = TrackConfig(
    pll_scale=1.0 / 16,
    fll_scale=1.0 / 16,
    dll_c1=0.25,
    dll_c2=75.0,
    snr_window_epochs=1000,
)

#: 20 ms coherent tracking: once bit sync is achieved the Costas loop
#: closes on whole-bit coherent sums (TrackConfig.coherent_pll), holding
#: phase and decoding nav data down to ~26-28 dBHz (measured: 0/1499
#: bit errors at 28, 27/1499 at 26; stock path needs ~42).  Bit sync
#: below ~36 dBHz comes from the aided histogram search
#: (track.aided_sync, auto-engaged by the Receiver).  The longer
#: pre-track window keeps the code-phase handoff reliable at 30 dBHz
#: (20 epochs occasionally picks a noise bin in the +/-7.5 chip zone).
#: The gentle per-epoch scales only matter BEFORE sync (the per-epoch
#: loop freezes once the coherent loop engages): they slow the Costas
#: random-walk away from the refine_doppler anchor at low C/N0, so the
#: first aided-sync window is clean.
#: bit_sync_up above the counter clamp (10) disables the RUN-TIME sync
#: declaration entirely: at the C/N0 this preset targets the flip
#: counters reliably declare sync on noise excursions with grids many
#: epochs off (observed: 9 epochs -> integer-ms pseudorange bias),
#: while the receiver's aided histogram search finds the true boundary
#: at >10 sigma within one window.  Sync comes only from
#: Receiver._maybe_aided_sync / track.aided_sync.engage_bit_sync.
COHERENT_TRACK = TrackConfig(
    coherent_pll=True,
    pre_track_epochs=100,
    pll_scale=1.0 / 16,
    fll_scale=1.0 / 16,
    bit_sync_up=1_000_000,
)

#: 100 ms data-wipeoff coherent tracking: COHERENT_TRACK plus the
#: extended multi-bit PLL (pll_ext_bits = 5 decided bits per Costas
#: update) and a narrower DLL.  Holds phase and decodes nav data ~4 dB
#: below COHERENT_TRACK (measured from a synced handoff,
#: tools/ext_pll_tune.py, 3 seeds x 74 bits each: 0/222 bit errors at
#: 24-25 dBHz where the per-bit loop makes 12/222; 2/222 at 23).
#: Below ~23 dBHz the errors are bit-DECISION-limited, not slip-limited
#: (4/222 at 22, 7/222 at 20 with 95p Doppler error still < 0.5 Hz —
#: consistent with the 20 ms Eb/N0 channel BER), i.e. the loop itself
#: holds to ~20 dBHz.  The 0.1 s coherent spans assume low platform
#: dynamics (the steady-state lag budget of the narrow loop covers the
#: GPS-orbit 0.5 Hz/s worst case but not vehicle jerk) and TCXO drift
#: << 1 ppm/s.
DEEP_COHERENT_TRACK = dataclasses.replace(
    COHERENT_TRACK,
    pll_ext_bits=5,
    dll_c1=0.25,
    dll_c2=75.0,
)


@dataclass(frozen=True)
class ReceiverConfig:
    """Top-level receiver configuration (the gps_master + main.c role)."""

    plan: SignalPlan = BASEBAND_PLAN
    acq: AcqConfig = AcqConfig()
    track: TrackConfig = TrackConfig()
    prns: tuple = (1, 2, 3, 4)
    doppler_hints_hz: tuple = ()      # per-PRN hints; empty => cold search
    solve_period_ms: int = 500        # GPS_CALC_POS_PERIOD_MS (gps_master.c:37)
    rtcm_period_ms: int = 200         # GPS_RTCM_SEND_PERIOD_MS (gps_master.c:36)
    status_period_ms: int = 300       # print_state.c:20-21
    code_filter_len: int = 100        # CODE_FILTER_LENGTH (config.h:38)
    enable_code_filter: bool = True   # ENABLE_CODE_FILTER (config.h:36)
    enable_position: bool = True      # ENABLE_CALC_POSITION (config.h:33)
    enable_rtcm: bool = False         # ENABLE_RTCM_SEND (config.h:30)
    track_block_epochs: int = 100     # epochs per jitted tracking scan call
    # Device-resident readback (runtime.digest): reduce each block's
    # (T, C) tracking outputs to a ~kB digest ON DEVICE (bit events +
    # last-epoch state + windowed statistics) instead of pulling them
    # all to the host.  Auto-disabled when the aided-sync/coherent
    # chain or correlator diagnostics need the full outputs.
    device_digest: bool = True
    # Background re-acquisition of not-yet-detected PRNs during
    # streaming (late-rising satellites); 0 disables.  The firmware's
    # channel set is fixed at compile time.
    reacquire_period_ms: int = 0
    # Channel demotion (drop_dead_channels): a live channel is
    # "healthy" whenever its measured C/N0 is at or above the floor;
    # a channel unhealthy for longer than the grace window is demoted
    # to standby.  Staleness-based so every failure mode demotes —
    # C/N0 collapsed, estimator returning 0 on noise (regardless of
    # the I/Q-ratio SNR), or a channel that decoded bits once and then
    # died.  The firmware tracks garbage forever (its watchdog only
    # kicks the carrier, tracking.c:306-326).
    cn0_floor_dbhz: float = 25.0
    demote_grace_ms: int = 1000
    # RAIM residual screening threshold (m); 0 disables (needs >= 6
    # satellites for fault identification).
    raim_threshold_m: float = 0.0
    # Reject solutions whose post-fit residual RMS exceeds this (m);
    # catches integer-ms boundary faults that converge to confidently
    # wrong fixes when too few satellites exist for RAIM.  0 disables.
    max_resid_rms_m: float = 5000.0
    # Aided bit sync (track.aided_sync): when the tracking config runs
    # the coherent PLL, channels that have not bit-synced after this
    # much prompt history get a histogram boundary search; confident
    # detections are engaged directly.  0 disables.
    # 4 s windows: the FIRST window after handoff is the best one (the
    # pre-sync loop's Doppler drift smears later windows), and at 4 s a
    # clean 30 dBHz window clears the single-shot sigma bar, engaging
    # before a cold start's first ephemeris subframe.
    aided_sync_window_ms: int = 4000
    aided_sync_min_sigma: float = 5.0
    # A synced channel that is genuinely tracking always shows bit
    # structure in its prompt signs, so persistent low histogram
    # confidence while synced means the grid or the carrier NCO is
    # wrong (e.g. a random-walk excursion of the run-time counters
    # declared sync on a bad boundary).  After this many consecutive
    # low-confidence windows the channel is re-anchored (refine_doppler
    # on raw samples) and de-synced so the next window can redo it.
    aided_sync_unhealthy_sigma: float = 3.0
    aided_sync_unhealthy_windows: int = 2
    # A single window can cross min_sigma on a noise cluster at a wrong
    # phase near the sensitivity floor (observed at 31 dBHz: grids 3-4
    # epochs off -> integer-ms pseudorange bias).  Engaging on a
    # moderate-confidence phase therefore requires two consecutive
    # windows agreeing within +/-1 epoch; a single window engages only
    # above the high bar.  Grid OVERRIDES of an already-synced channel
    # always require the two-window agreement.
    aided_sync_repeat_sigma: float = 3.5
    aided_sync_single_sigma: float = 6.0
    # Physical plausibility gate on converged solutions
    # (pvt.solve.solution_plausible): closes the 4-satellite
    # boundary-integrity hole where a single channel's integer-ms grid
    # fault yields a converged ZERO-residual wrong fix that no residual
    # test can see.  Altitude window covers terrestrial + aviation
    # users; the clock-bias window is asymmetric because the relative
    # pseudorange convention makes the solved bias 68.802 ms - TOF_ref
    # (see pvt.solve.solution_plausible).  min>=max disables either
    # window.
    # The Doppler-implied receiver speed is the sharpest discriminator
    # (a wrong position forces a km/s-scale phantom velocity); 600 m/s
    # covers any aircraft.  0 disables.
    min_altitude_m: float = -1000.0
    max_altitude_m: float = 100_000.0
    min_clock_bias_ms: float = -19.0
    max_clock_bias_ms: float = 3.0
    max_speed_mps: float = 600.0
    # When a solution fails the plausibility gate, search for a unique
    # single-channel integer-ms fault (pvt.solve.identify_grid_fault)
    # and, if found, correct the fix AND the channel's boundary ledger
    # going forward (ChannelStatus.grid_bias_ms).  False = reject only.
    grid_fault_search: bool = True

    def replace(self, **kw) -> "ReceiverConfig":
        return dataclasses.replace(self, **kw)
