"""LNAV word/subframe framing state machine (host side).

Per-channel re-implementation of the firmware's framing logic
(``nav_data.c:257-453``): preamble search in a 30-bit shift window,
inverted-preamble polarity resolution, per-word parity check with D29/D30
chaining (the aholme/IS-GPS-200 equations, nav_data.c:433-453), 10-word
subframe assembly with re-sync on parity failure, and the polarity
re-detect timeout.  Control-heavy, tiny data (50 bps) — deliberately host
Python per SURVEY.md §7; the device-side scan supplies (bit, epoch)
events.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from ..config import (
    PREAMBLE_BITS,
    SUBFRAME_DURATION_MS,
    WORD_LENGTH_BITS,
    WORDS_IN_SUBFRAME,
)

# Parity equations (nav_data.c:443-448): D25..D30 from source bits d1..d24
# and previous received D29/D30.
_PARITY_TAPS = (
    (1, 2, 3, 5, 6, 10, 11, 12, 13, 14, 17, 18, 20, 23),
    (2, 3, 4, 6, 7, 11, 12, 13, 14, 15, 18, 19, 21, 24),
    (1, 3, 4, 5, 7, 8, 12, 13, 14, 15, 16, 19, 20, 22),
    (2, 4, 5, 6, 8, 9, 13, 14, 15, 16, 17, 20, 21, 23),
    (1, 3, 5, 6, 7, 9, 10, 14, 15, 16, 17, 18, 21, 22, 24),
    (3, 5, 6, 8, 9, 10, 11, 13, 15, 19, 22, 23, 24),
)
_PARITY_SEED = ("D29", "D30", "D29", "D30", "D30", "D29")

#: polarity re-detect timeout: two subframes (nav_data.c:22)
BAD_POLARITY_TIMEOUT_MS = 2 * SUBFRAME_DURATION_MS

# Preamble as an 8-bit integer (and its inversion) for the shift-
# register match in the hot bit loop — equality on one int replaces a
# per-bit list slice + tuple build (the framer is the dominant
# per-channel host cost at high channel counts, tools/host_cost_probe.py).
_PRE_INT = 0
for _b in PREAMBLE_BITS:
    _PRE_INT = (_PRE_INT << 1) | _b
_PRE_INV_INT = _PRE_INT ^ 0xFF
_PRE_LEN = len(PREAMBLE_BITS)


def check_parity(word_bits, d29: int, d30: int) -> Optional[List[int]]:
    """Validate one received 30-bit word.

    Returns the 24 *source* data bits (un-inverted by D30) when parity
    passes, else None — the contract of gps_nav_data_word_check_parity
    (nav_data.c:433-453).
    """
    d = [b ^ d30 for b in word_bits[:24]]
    for k, (taps, seed) in enumerate(zip(_PARITY_TAPS, _PARITY_SEED)):
        p = d29 if seed == "D29" else d30
        for t in taps:
            p ^= d[t - 1]
        if p != word_bits[24 + k]:
            return None
    return d


@dataclass
class SubframeEvent:
    """A successfully framed 300-bit subframe."""

    subframe_id: int
    bits: List[int]              # 300 source data+parity bits (240 data)
    start_epoch_ms: int          # epoch of the subframe's first bit
    word_count: int


@dataclass
class NavFramer:
    """Framing state for one channel (gps_nav_data_t word fields,
    gps_misc.h:101-133)."""

    window: List[int] = field(default_factory=list)       # received bits
    window_epochs: List[int] = field(default_factory=list)
    word_cnt: int = 0
    d29: int = 0
    d30: int = 0
    subframe_bits: List[int] = field(default_factory=list)
    subframe_start_epoch: int = 0
    inv_polarity: bool = False
    polarity_found: bool = False
    inv_preamble_cnt: int = 0
    bit_counter: int = 0
    inv_hit_bits: List[int] = field(default_factory=list)
    history: List[tuple] = field(default_factory=list)  # (raw_bit, epoch)
    _replaying: bool = False
    last_word_epoch: int = 0
    #: polarity re-detect timeout (nav_data.c:22): reopened inverted-
    #: preamble detection after this long without a valid word.  Two
    #: subframe durations ON AIR — callers running compressed time
    #: (codes_in_bit < 20) must scale it, else a PLL half-cycle slip
    #: mid-run silences framing for the fixed 12 s real-time value.
    polarity_timeout_ms: int = BAD_POLARITY_TIMEOUT_MS
    words_decoded: int = 0       # word_cnt_test equivalent
    subframe_cnt: int = 0
    last_subframe_time_ms: int = 0   # last_subframe_time ledger
    first_subframe_time_ms: int = 0  # latched once by the master
    # rolling 30-bit register mirroring ``window`` during the preamble
    # hunt (hot-loop optimization; rebuilt by _sync_pre_reg on resets)
    pre_reg: int = 0

    def __post_init__(self):
        # derive the register from the window on ANY construction —
        # including checkpoints written before the field existed
        self._sync_pre_reg()

    def push_bit(self, bit: int, epoch_ms: int) -> List[SubframeEvent]:
        """Feed one 20 ms nav bit (pre-polarity) ending the epoch window
        that *started* at ``epoch_ms``.  Returns completed subframes."""
        events: List[SubframeEvent] = []
        self.bit_counter += 1
        if not self._replaying:
            # raw-bit ring for post-polarity-flip replay (~2 subframes);
            # trimmed in slabs (amortized O(1) — a per-bit pop(0) was a
            # measurable slice of the per-channel host cost), replay
            # reads the last 640 entries so semantics are unchanged
            self.history.append((bit, epoch_ms))
            if len(self.history) >= 704:
                del self.history[:-640]
        if self.inv_polarity:
            bit ^= 1

        if self.word_cnt == 0:
            # Preamble hunt in a sliding 30-bit window (nav_data.c:259-307)
            self.window.append(bit)
            self.window_epochs.append(epoch_ms)
            self.pre_reg = ((self.pre_reg << 1) | bit) & 0x3FFFFFFF
            if len(self.window) > WORD_LENGTH_BITS:
                self.window.pop(0)
                self.window_epochs.pop(0)
            if len(self.window) == WORD_LENGTH_BITS:
                head = self.pre_reg >> (WORD_LENGTH_BITS - _PRE_LEN)
                if head == _PRE_INT:
                    self._accept_word(list(self.window),
                                      self.window_epochs[0])
                    self.inv_preamble_cnt = 0
                elif (
                    not self.polarity_found
                    and head == _PRE_INV_INT
                ):
                    # 180-degree phase ambiguity detection
                    # (nav_data.c:281-291).  The firmware counts two
                    # inverted-preamble sightings; random data bits also
                    # produce the pattern (~every 256 bits), so we
                    # additionally require two sightings exactly a
                    # subframe (300 bits) apart — real TLM preambles
                    # align, data hits don't.
                    here = self.bit_counter
                    aligned = any(
                        (here - h) % 300 == 0 for h in self.inv_hit_bits
                    )
                    self.inv_hit_bits.append(here)
                    self.inv_hit_bits = self.inv_hit_bits[-8:]
                    if aligned:
                        # Flip polarity and REPLAY the buffered raw bits
                        # through the framing logic with the corrected
                        # polarity: the subframe that passed between the
                        # two TLM sightings is recovered instead of lost
                        # (the firmware waits for the next one,
                        # nav_data.c:281-291 — up to 6 s slower TTFF).
                        self.inv_polarity = not self.inv_polarity
                        self.inv_hit_bits = []
                        self.window = []
                        self.window_epochs = []
                        self.pre_reg = 0
                        self.word_cnt = 0
                        self.subframe_bits = []
                        events.extend(self._replay_history())
                        return events
            # Polarity re-detect timeout (nav_data.c:293-306)
            if (
                self.polarity_found
                and not self._replaying
                and epoch_ms - self.last_word_epoch > self.polarity_timeout_ms
            ):
                self.polarity_found = False
                self.inv_polarity = False
                self.last_word_epoch = epoch_ms
        else:
            self.window.append(bit)
            self.window_epochs.append(epoch_ms)
            if len(self.window) >= WORD_LENGTH_BITS:
                word = self.window[:WORD_LENGTH_BITS]
                epochs = self.window_epochs[:WORD_LENGTH_BITS]
                start = epochs[0]
                self.window = []
                self.window_epochs = []
                data = check_parity(word, self.d29, self.d30)
                if data is None:
                    # re-sync (nav_data.c:344-347); unlike the firmware,
                    # re-feed the failed word's bits into the sliding
                    # preamble hunt so a true TLM inside them is not lost
                    self.word_cnt = 0
                    self.subframe_bits = []
                    self.window = word[1:]
                    self.window_epochs = epochs[1:]
                    self._sync_pre_reg()
                else:
                    self._store_word(word, data)
                    self.words_decoded += 1
                    self.last_word_epoch = start
                    if not self.polarity_found:
                        self.polarity_found = True
                    if self.word_cnt == WORDS_IN_SUBFRAME:
                        events.append(
                            SubframeEvent(
                                subframe_id=subframe_id(self.subframe_bits),
                                bits=list(self.subframe_bits),
                                start_epoch_ms=self.subframe_start_epoch,
                                word_count=self.words_decoded,
                            )
                        )
                        self.subframe_cnt += 1
                        self.last_subframe_time_ms = self.subframe_start_epoch
                        self.word_cnt = 0
                        self.subframe_bits = []
        return events

    # -- internals ---------------------------------------------------------

    def _sync_pre_reg(self) -> None:
        """Rebuild the rolling preamble register from ``window`` (reset
        paths only — the hot loop maintains it incrementally)."""
        r = 0
        for b in self.window:
            r = ((r << 1) | b) & 0x3FFFFFFF
        self.pre_reg = r

    def _replay_history(self) -> List[SubframeEvent]:
        """Re-feed the buffered raw bits with the (now corrected)
        polarity.  Polarity detection is suppressed during replay; the
        history is not re-recorded."""
        self._replaying = True
        self.polarity_found = True   # suppress inverted-preamble logic
        events: List[SubframeEvent] = []
        try:
            for raw_bit, ep in self.history[-640:]:
                events.extend(self.push_bit(raw_bit, ep))
        finally:
            self._replaying = False
        return events

    def _accept_word(self, word: List[int], start_epoch: int):
        """First word of a (candidate) subframe found by preamble match
        (nav_data.c:270-279).  Parity of this word is checked when the
        *next* word completes (d29/d30 were not yet known for it in the
        firmware either — it stores the word as-is)."""
        self.subframe_bits = []
        self.subframe_start_epoch = start_epoch
        # The firmware stores word 1 un-checked; its data bits are valid
        # as-is because the previous word's solved tail forces D30=0
        # (nav_message._solve_tail_bits).
        self._store_word(word, word[:24])
        self.word_cnt = 1
        self.window = []
        self.window_epochs = []
        self.pre_reg = 0

    def _store_word(self, word: List[int], data: List[int]):
        self.subframe_bits.extend(data + word[24:])
        self.d29, self.d30 = word[28], word[29]
        self.word_cnt += 1


def subframe_id(subframe_bits) -> int:
    """Subframe ID = bits 49-51 of the subframe (HOW bits 20-22),
    nav_data_decode.c:35."""
    b = subframe_bits
    return (b[49] << 2) | (b[50] << 1) | b[51]
