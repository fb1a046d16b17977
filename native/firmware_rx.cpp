// Firmware-semantics multi-channel 1-bit GPS receiver (parity oracle).
//
// A COMPLETE acquisition -> pre-track -> tracking -> bit-extraction ->
// subframe-ledger -> relative-pseudorange chain with the reference
// firmware's exact numeric semantics, driven over a recorded/synthesized
// 16.368 MHz 1-bit capture.  Used by tests/test_firmware_parity.py to
// assert that the JAX pipeline reproduces the firmware pipeline's
// nav-bit stream bit-exactly, its code phase / Doppler within the
// firmware's quantization, and (fw_master_run) its relative
// pseudoranges — the BASELINE.md correctness line, compared
// pipeline-against-pipeline rather than each-against-planted-truth.
//
// This is a fresh implementation built from studying the reference
// (file:line cites below refer to /root/reference/Firmware/project_main);
// it deliberately reproduces the firmware's quirks because they are the
// behavior being checked against:
//
//  * the carrier NCO's binary Fs/4 patterns include the 7-digit
//    0x9999999 literal (gps_misc.c:216-217,247-248) — two samples of
//    every 32 differ from the ideal 0x99999999 pattern;
//  * gps_mult_and_summ's odd-offset path correlates one 16-bit word
//    LESS than the even path and restarts at byte 1 (gps_misc.c:57-89);
//  * gps_generate_prn_data2 writes the sub-chip-shifted replica with
//    32-bit stores so chip 1022 spills into a 1024th guard word, and
//    the first offset_bits samples stay ZERO (no circular tail)
//    (gps_misc.c:282-300, common_ram.h guard word);
//  * the PLL discriminator divides by pi but its "wrap" checks compare
//    against pi/2 on a value already inside [-0.5, 0.5]
//    (tracking.c:181-192) — mirrored as written;
//  * tracking services the channel only on its 4-of-17 TDM slots with
//    NCO phase rewind for the skipped epochs (main.c:140-152,
//    gps_misc.c:196-204);
//  * the cold frequency search's shared vote buffers are reset after
//    EVERY 10-epoch batch (acquisition_buffers_reset inside
//    acquisition_freq_search, acquisition.c:303), so the frequency
//    histogram only ever holds the current bin's vote — acceptance is
//    effectively "this bin's sorted-chain length >= 3" and the
//    ratio-1.7 branch is dead code.  Mirrored as written;
//  * the freq-search chain detector's END-of-buffer check ignores
//    same_flag (acquisition.c:350-351) — mirrored.
//
// Time compression: the MCU's slow acquisition path processes snapshot
// copies ~0.2 s apart (acquisition.c:279 comment); the oracle feeds
// CONSECUTIVE milliseconds instead, so acquisition converges in
// capture-time rather than wall-time.  Detection statistics per epoch
// are identical; the 120 s code-search timeout is ported but rarely
// reachable in compressed time.
//
// Built into libsdr_native.so (plain C ABI, ctypes-bound).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

constexpr int kBitsInPrn = 16368;      // config.h:26
constexpr int kWords = 1023;           // config.h:27 (16-bit words / ms)
constexpr int kPrnLen = 1023;          // config.h:28
constexpr int kIfHz = 4092000;         // config.h:23
constexpr float kNcoStepHz = 0.003810972f;  // config.h:53
constexpr int kTrackChLen = 4;         // config.h:56 TRACKING_CH_LENGTH
constexpr int kCodesInBit = 20;        // nav_data.c:15
constexpr int kFineRatio = 8;          // tracking.c:23 (bytes per 0.5 chip)
constexpr int kPreTrackZone = 30;      // tracking.c:17
constexpr int kPreTrackStep = kPreTrackZone / kTrackChLen;
constexpr int kPreTrackPointsMax = 30; // config.h:50
constexpr int kHistSize = 32;          // config.h:48
constexpr int kHistStep1 = 64;         // config.h:47
constexpr int kSearch2Width = 500;     // acquisition.c:15
constexpr int kSearch3Width = 60;      // acquisition.c:16
constexpr int kAcqTimeoutMs = 120000;  // acquisition.c:13
constexpr int kFreqSpanHz = 7000;      // config.h:41 ACQ_SEARCH_FREQ_HZ
constexpr int kFreqStepHz = 500;       // config.h:42 ACQ_SEARCH_STEP_HZ
constexpr int kFreqBins = 2 * kFreqSpanHz / kFreqStepHz + 1;  // 29
constexpr int kSingleFreqLen = 10;     // acquisition.c:18
constexpr int kFreqPointsMax = 25;     // acquisition.c:12
constexpr float kDll1C1 = 1.0f, kDll1C2 = 300.0f;     // config.h:61-62
constexpr float kPll1C1 = 4.0f, kPll1C2 = 3000.0f;    // config.h:64-65
constexpr float kPll2C1 = 8.0f, kPll2C2 = 5000.0f;    // config.h:67-68
constexpr float kFll1C1 = 200.0f, kFll1C2 = 2000.0f;  // config.h:70-71
constexpr double kGpsOffsetTimeMs = 68.802;    // gps_master.c:31
constexpr double kClightNorm = 299792458.0 / 1000.0;  // gps_master.c:33
constexpr int kSubframeMs = 6000;      // gps_master.c:34
constexpr uint32_t kCodeFilterLen = 100;  // CODE_FILTER_LENGTH config.h:38

const uint8_t kPreamble[8] = {1, 0, 0, 0, 1, 0, 1, 1};  // nav_data.c:26

// Acquisition states (gps_misc.h:20-32)
enum AcqState {
  kAcqNeedFreqSearch = 0,
  kAcqFreqSearchRun,
  kAcqFreqSearchDone,
  kAcqCodeSearch1,
  kAcqCodeSearch1Done,
  kAcqCodeSearch2,
  kAcqCodeSearch2Done,
  kAcqCodeSearch3,
  kAcqCodeSearch3Done,
  kAcqDone,
};

// popcount LUT (the firmware builds a 64 KiB table at boot,
// gps_misc.c:11-38; __builtin_popcount is bit-identical)
inline int pop16(uint16_t v) { return __builtin_popcount((unsigned)v); }

// ---- C/A code generation (gps_misc.c:317-372 capability; the G2 delay
// table is the IS-GPS-200 constant set) --------------------------------
void ca_code(int prn, uint8_t* chips /*1023 of 0/1*/) {
  static const int kDelay[33] = {0,   5,   6,   7,   8,   17,  18,  139,
                                 140, 141, 251, 252, 254, 255, 256, 257,
                                 258, 469, 470, 471, 472, 473, 474, 509,
                                 512, 513, 514, 515, 516, 859, 860, 861,
                                 862};
  int8_t g1[kPrnLen], g2[kPrnLen];
  int r1[10], r2[10];
  for (int i = 0; i < 10; ++i) r1[i] = r2[i] = 1;
  for (int i = 0; i < kPrnLen; ++i) {
    g1[i] = (int8_t)r1[9];
    g2[i] = (int8_t)r2[9];
    int c1 = r1[2] ^ r1[9];
    int c2 = r2[1] ^ r2[2] ^ r2[5] ^ r2[7] ^ r2[8] ^ r2[9];
    for (int j = 9; j > 0; --j) {
      r1[j] = r1[j - 1];
      r2[j] = r2[j - 1];
    }
    r1[0] = c1;
    r2[0] = c2;
  }
  const int d = kDelay[prn];
  for (int i = 0; i < kPrnLen; ++i) {
    chips[i] = (uint8_t)(g1[i] ^ g2[(i + kPrnLen - d) % kPrnLen]);
  }
}

// ---- gps_generate_prn_data2 (gps_misc.c:282-300): code NCO, 16
// samples/chip, sub-chip shift 0..15, 32-bit stores spilling into a
// guard word; leading offset_bits samples stay zero ---------------------
void generate_prn_data2(const uint8_t* chips, uint16_t* data /*1024 words*/,
                        uint16_t offset_bits) {
  std::memset(data, 0, (kWords + 1) * 2);
  const uint32_t wr_word = 0x0000FFFFu << (offset_bits & 15);
  for (int w = 0; w < kWords; ++w) {
    if (chips[w]) {
      uint32_t cur;
      std::memcpy(&cur, &data[w], 4);
      cur |= wr_word;
      std::memcpy(&data[w], &cur, 4);
    }
  }
}

// ---- carrier NCO (gps_misc.c:211-274): 32-bit phase accumulator, XOR
// with binary Fs/4 sin/cos patterns selected by the top 2 phase bits;
// the 0x9999999 literals are the firmware's (quirk preserved) ----------
void shift_to_zero_freq(const uint8_t* signal, uint8_t* di, uint8_t* dq,
                        float freq_hz, uint32_t* accum_io) {
  static const uint32_t kSin[4] = {0x33333333u, 0x9999999u, 0xCCCCCCCCu,
                                   0x66666666u};
  static const uint32_t kCos[4] = {0x9999999u, 0xCCCCCCCCu, 0x66666666u,
                                   0x33333333u};
  uint32_t acc_step = (uint32_t)(freq_hz / kNcoStepHz);
  acc_step = (uint32_t)((uint64_t)acc_step * 32);
  uint32_t accum = accum_io ? *accum_io : 0;
  for (int w = 0; w < kWords / 2 * 2 / 2; ++w) {  // 511 32-bit words
    // NOTE: PRN_SPI_WORDS_CNT / 2 = 511 (integer division of 1023) —
    // the firmware processes 511 32-bit words = 16352 samples and
    // leaves the last 16-bit word of I/Q UNwritten each epoch
    // (gps_misc.c:229).  Quirk preserved: the stale last word carries
    // over in the shared scratch buffers.
    uint32_t sw, iw, qw;
    std::memcpy(&sw, signal + 4 * w, 4);
    const uint32_t phase = accum >> 30;
    iw = kCos[phase] ^ sw;
    qw = kSin[phase] ^ sw;
    std::memcpy(di + 4 * w, &iw, 4);
    std::memcpy(dq + 4 * w, &qw, 4);
    accum += acc_step;
  }
  if (accum_io) *accum_io = accum;
}

// gps_rewind_if_phase (gps_misc.c:196-204)
void rewind_if_phase(uint32_t* accum, float if_freq_offset_hz, int steps) {
  uint32_t acc_step = (uint32_t)(((float)kIfHz + if_freq_offset_hz) /
                                 kNcoStepHz);
  acc_step = (uint32_t)((uint64_t)acc_step * kBitsInPrn * (uint32_t)steps);
  *accum += acc_step;
}

// ---- gps_mult_and_summ (gps_misc.c:48-93) with the exact odd-offset
// semantics: odd offsets process one word less and restart at byte 1 ---
void mult_and_summ(const uint8_t* src_i, const uint8_t* src_q,
                   const uint8_t* src2, uint16_t* summ_i, uint16_t* summ_q,
                   uint16_t length, uint16_t offset) {
  const uint8_t small_offset = (uint8_t)(offset & 1);
  const uint16_t len_words_p1 = (uint16_t)((length - offset) / 2);
  uint16_t ci = 0, cq = 0;
  const uint8_t* pi = src_i + offset;
  const uint8_t* pq = src_q + offset;
  uint16_t w2, wi, wq;
  for (uint16_t i = 0; i < len_words_p1; ++i) {
    std::memcpy(&w2, src2 + 2 * i, 2);
    std::memcpy(&wi, pi + 2 * i, 2);
    std::memcpy(&wq, pq + 2 * i, 2);
    ci = (uint16_t)(ci + pop16((uint16_t)(wi ^ w2)));
    cq = (uint16_t)(cq + pop16((uint16_t)(wq ^ w2)));
  }
  pi = src_i + small_offset;
  pq = src_q + small_offset;
  uint16_t j = 0;
  for (uint16_t i = (uint16_t)(len_words_p1 + small_offset);
       i < (uint16_t)(length / 2 - small_offset); ++i, ++j) {
    std::memcpy(&w2, src2 + 2 * i, 2);
    std::memcpy(&wi, pi + 2 * j, 2);
    std::memcpy(&wq, pq + 2 * j, 2);
    ci = (uint16_t)(ci + pop16((uint16_t)(wi ^ w2)));
    cq = (uint16_t)(cq + pop16((uint16_t)(wq ^ w2)));
  }
  *summ_i = ci;
  *summ_q = cq;
}

// gps_correlation_iq (gps_misc.c:128-145)
void correlation_iq(const uint16_t* prn, const uint16_t* di,
                    const uint16_t* dq, uint16_t offset, int16_t* ri,
                    int16_t* rq) {
  uint16_t si, sq;
  mult_and_summ((const uint8_t*)di, (const uint8_t*)dq, (const uint8_t*)prn,
                &si, &sq, kWords * 2, offset);
  *ri = (int16_t)((int16_t)si - kBitsInPrn / 2);
  *rq = (int16_t)((int16_t)sq - kBitsInPrn / 2);
}

// gps_correlation8 (gps_misc.c:98-122)
int16_t correlation8(const uint16_t* prn, const uint16_t* di,
                     const uint16_t* dq, uint16_t offset) {
  int16_t s1, s2;
  correlation_iq(prn, di, dq, offset, &s1, &s2);
  if (s1 < 0) s1 = 0;
  if (s2 < 0) s2 = 0;
  const int32_t m = (int32_t)s1 * s1 + (int32_t)s2 * s2;
  return (int16_t)sqrtf((float)m);
}

// correlation_search (gps_misc.c:155-191)
uint16_t correlation_search(const uint16_t* prn, const uint16_t* di,
                            const uint16_t* dq, uint16_t start,
                            uint16_t stop, uint16_t* aver, uint16_t* phase) {
  uint16_t best_pos = 0;
  int16_t best_val = 0;
  int32_t total = 0;
  for (uint16_t off = start; off < stop; ++off) {
    const int16_t c = correlation8(prn, di, dq, off);
    if (c > best_val) {
      best_val = c;
      best_pos = off;
    }
    total += c;
  }
  total /= (kPrnLen * 2);
  if (total < 0) total = 0;
  *aver = (uint16_t)total;
  *phase = best_pos;
  return (uint16_t)best_val;
}

// ---- channel state ----------------------------------------------------
struct FwChannel {
  int prn = 0;
  uint8_t prn_code[kPrnLen];
  // acquisition (acquisition.c state machine, gps_misc.h:20-32)
  int acq_state = kAcqNeedFreqSearch;
  int16_t given_freq_hz = 0;     // given_freq_offset_hz (0 = cold search)
  int16_t found_freq_hz = 0;
  uint16_t found_code_phase = 0;
  uint16_t search_start = 0, search_stop = 2 * kPrnLen;
  uint16_t hist_step = kHistStep1;
  uint8_t hist[kHistSize] = {0};
  uint32_t acq_start_timestamp = 0;
  // cold frequency search (acquisition.c:280-416).  The reference
  // keeps these in GLOBAL shared buffers reset between channels; the
  // search runs one channel at a time, so per-channel storage with the
  // same reset points is equivalent.
  uint8_t freq_index = 0;
  uint16_t single_freq_phases[kFreqPointsMax] = {0};
  uint8_t single_freq_count = 0;
  uint32_t freq_hist[kFreqBins] = {0};
  // pre-track (tracking.c:398-499)
  int state = 0;  // 0 acq, 2 pre-track, 3 tracking (gps_misc.h tracking)
  float if_freq_offset_hz = 0.0f;
  uint16_t code_search_start = 0, code_search_stop = 0;
  uint16_t pre_track_phases[kPreTrackPointsMax] = {0};
  int pre_track_count = 0;
  uint16_t ptk_best_val = 0, ptk_best_phase = 0;
  // tracking (tracking.c:92-393)
  float code_phase_fine = 0.0f;
  float dll_code_err = 0.0f;
  float pll_code_err = 0.0f;
  float fll_err = 0.0f;
  int16_t fll_old_i = 0, fll_old_q = 0;
  uint32_t if_freq_accum = 0;
  uint32_t prev_track_timestamp = 0;
  int16_t pll_check_buf[kTrackChLen] = {0};
  int pll_bad_cnt = 0, pll_bad_master = 0;
  // nav data (nav_data.c)
  int inv_polarity_flag = 0, polarity_found = 0, inv_preamble_cnt = 0;
  uint32_t old_swap_time = 0;
  int right_period_cnt = 0, period_sync_ok = 0;
  uint8_t old_reminder = 0;
  int pos_cnt = 0, neg_cnt = 0;
  uint8_t word_buf[30] = {0};
  int word_cnt = 0, word_bit_cnt = 0;
  uint8_t oldD29 = 0, oldD30 = 0;
  uint32_t word_detection_timestamp = 0;
  // accurate swap-time refinement + subframe ledger (nav_data.c:145-218,
  // :352-378; gps_misc.h nav_data fields)
  uint8_t accurate_swap_ok = 0;
  uint32_t accurate_swap_time = 0;   // residue mod CODES_IN_BIT
  uint8_t subframe_bits[300] = {0};  // assembled subframe (data+parity)
  uint32_t last_subframe_time = 0;
  uint32_t first_subframe_time = 0;
  uint16_t subframe_cnt = 0;
  uint8_t new_subframe_flag = 0;
  double tow_gpst = 0.0;             // HOW TOW * 6 (nav_data_decode.c:58)
  // observables (gps_master.c:228-247 swap ledger)
  float old_code_phase_fine = 0.0f;
  uint8_t code_phase_swap_flag = 0;
  double pseudorange_m = 0.0;
  double tow_s = 0.0;
  // ENABLE_CODE_FILTER accumulator (gps_misc.h:92, tracking.c:371-385,
  // gps_master.c:332-388; config.h:36 defaults the filter ON)
  float code_phase_fine_filt = 0.0f;
  uint32_t code_filt_cnt = 0;
  uint32_t filt_start_time_ms = 0;
  // per-slot scratch (nav_data.c:48-51 statics)
  uint8_t tmp_nav[kTrackChLen] = {0};
  int16_t raw_ip[kTrackChLen] = {0};
  uint32_t slot_start_time = 0;
  int subframe_count = 0;
};

// shared scratch (the common_ram.c role: 1023+1 guard word each)
struct Scratch {
  uint16_t prn[kWords + 1];
  uint16_t di[kWords + 1];
  uint16_t dq[kWords + 1];
};

struct Outputs {
  int8_t* bits = nullptr;
  int32_t* bit_times = nullptr;
  int32_t bit_cap = 0, bit_cnt = 0;
  float* cp_traj = nullptr;
  float* dop_traj = nullptr;
  int32_t* traj_times = nullptr;
  int32_t traj_cap = 0, traj_cnt = 0;
  int32_t subframes = 0;
  int32_t track_start_ms = -1;
  int32_t sync_ms = -1;
};

// ---- acquisition: cold frequency search (acquisition.c:280-416) -------

void acq_buffers_reset(FwChannel& ch) {
  // acquisition_buffers_reset (acquisition.c:60-65): clears BOTH the
  // per-batch phase buffer and the frequency histogram
  std::memset(ch.freq_hist, 0, sizeof(ch.freq_hist));
  std::memset(ch.single_freq_phases, 0, sizeof(ch.single_freq_phases));
  ch.single_freq_count = 0;
}

// acquisition_process_single_freq_data (acquisition.c:322-360): sort the
// batch's best phases, find the longest chain of near-equal values
void acq_process_single_freq_data(FwChannel& ch, int points_cnt) {
  uint16_t* p = ch.single_freq_phases;
  for (int i = 1; i < points_cnt; ++i) {  // insertion sort (qsort role)
    const uint16_t v = p[i];
    int j = i - 1;
    while (j >= 0 && p[j] > v) {
      p[j + 1] = p[j];
      --j;
    }
    p[j + 1] = v;
  }
  int chain_items = 0;
  int max_chain = 0;
  int same_flag = 0;
  for (int i = 1; i < points_cnt; ++i) {
    const int diff = (int)p[i] - (int)p[i - 1];
    if (abs(diff) < 3) same_flag = 1;
    if (abs(diff) < 15) {
      chain_items++;
    } else {
      if (chain_items > max_chain && same_flag) max_chain = chain_items;
      chain_items = 0;
      same_flag = 0;
    }
  }
  // final chain: the reference checks WITHOUT same_flag here
  // (acquisition.c:350-351) — quirk preserved
  if (chain_items > max_chain) max_chain = chain_items;
  if (max_chain >= 2) ch.freq_hist[ch.freq_index] += (uint32_t)max_chain;
}

// acquisition_process_single_freq_histogram (acquisition.c:365-416)
void acq_process_single_freq_histogram(FwChannel& ch) {
  int non_zero = 0;
  int max_pos = 0;
  uint32_t max_val = 0;
  for (int i = 0; i < kFreqBins; ++i) {
    if (ch.freq_hist[i] > 0) non_zero++;
    if (ch.freq_hist[i] > max_val) {
      max_val = ch.freq_hist[i];
      max_pos = i;
    }
  }
  if (non_zero == 1 && max_val >= 3) {
    ch.acq_state = kAcqFreqSearchDone;
    ch.found_freq_hz = (int16_t)(-kFreqSpanHz + max_pos * kFreqStepHz);
  } else if (non_zero > 1) {
    // dead in practice (the per-batch reset keeps the histogram
    // single-binned) but ported for structural parity
    float min_ratio = 10.0f;
    for (int i = 0; i < kFreqBins; ++i) {
      if (ch.freq_hist[i] > 0 && i != max_pos) {
        const float r = (float)max_val / (float)ch.freq_hist[i];
        if (r < min_ratio) min_ratio = r;
      }
    }
    if (min_ratio > 1.7f) {
      ch.acq_state = kAcqFreqSearchDone;
      ch.found_freq_hz = (int16_t)(-kFreqSpanHz + max_pos * kFreqStepHz);
    }
  }
}

// acquisition_freq_search (acquisition.c:280-312)
void acq_freq_search(FwChannel& ch, const uint8_t* data, Scratch& s) {
  generate_prn_data2(ch.prn_code, s.prn, 0);
  const int16_t freq_offset_hz =
      (int16_t)(-kFreqSpanHz + ch.freq_index * kFreqStepHz);
  shift_to_zero_freq(data, (uint8_t*)s.di, (uint8_t*)s.dq,
                     (float)(kIfHz + freq_offset_hz), nullptr);
  uint16_t aver, best_phase = 0;
  correlation_search(s.prn, s.di, s.dq, 0, kPrnLen * 2, &aver, &best_phase);
  ch.single_freq_phases[ch.single_freq_count++] = best_phase;
  if (ch.single_freq_count >= kSingleFreqLen) {
    acq_process_single_freq_data(ch, ch.single_freq_count);
    acq_process_single_freq_histogram(ch);
    acq_buffers_reset(ch);
    ch.freq_index++;
    if (ch.freq_index >= kFreqBins) ch.freq_index = 0;
  }
}

// acquisition_start_channel (acquisition.c:68-85)
void acq_start_channel(FwChannel& ch) {
  if (ch.acq_state == kAcqNeedFreqSearch) {
    if (ch.given_freq_hz != 0) {
      ch.found_freq_hz = ch.given_freq_hz;
      ch.acq_state = kAcqFreqSearchDone;
      return;
    }
    acq_buffers_reset(ch);
    ch.freq_index = 0;
    ch.acq_state = kAcqFreqSearchRun;
  }
}

// acquisition_start_code_search_channel (acquisition.c:89-102)
void acq_start_code_search(FwChannel& ch, uint32_t now) {
  if (ch.acq_state == kAcqFreqSearchDone) {
    std::memset(ch.hist, 0, sizeof(ch.hist));
    ch.search_start = 0;
    ch.search_stop = 2 * kPrnLen;
    ch.hist_step = kHistStep1;
    ch.acq_start_timestamp = now;
    ch.acq_state = kAcqCodeSearch1;
  }
}

// acquisition_start_code_search3_channel (acquisition.c:106-130)
void acq_start_code_search3(FwChannel& ch, uint32_t now) {
  if (ch.acq_state == kAcqCodeSearch2Done) {
    std::memset(ch.hist, 0, sizeof(ch.hist));
    ch.search_start = (uint16_t)(ch.found_code_phase - kSearch3Width / 2);
    ch.search_stop = (uint16_t)(ch.found_code_phase + kSearch3Width / 2);
    if (ch.search_start > 2 * kPrnLen) ch.search_start = 0;
    if (ch.search_stop > 2 * kPrnLen) ch.search_stop = 2 * kPrnLen;
    ch.hist_step = kSearch3Width / kHistSize + 1;
    acq_buffers_reset(ch);
    ch.acq_start_timestamp = now;
    ch.acq_state = kAcqCodeSearch3;
  }
}

// acquisition_code_phase_search (acquisition.c:196-275)
void acq_code_phase_search(FwChannel& ch, const uint8_t* data, Scratch& s,
                           uint32_t now) {
  generate_prn_data2(ch.prn_code, s.prn, 0);
  shift_to_zero_freq(data, (uint8_t*)s.di, (uint8_t*)s.dq,
                     (float)(kIfHz + ch.found_freq_hz), nullptr);
  uint16_t aver, best = 0;
  correlation_search(s.prn, s.di, s.dq, ch.search_start, ch.search_stop,
                     &aver, &best);
  if (best < ch.search_start || best >= ch.search_stop) return;
  if (now - ch.acq_start_timestamp > (uint32_t)kAcqTimeoutMs) {
    // 120 s histogram reset (acquisition.c:217-224)
    std::memset(ch.hist, 0, sizeof(ch.hist));
    ch.acq_start_timestamp = now;
  }
  const uint8_t idx = (uint8_t)((best - ch.search_start) / ch.hist_step);
  if (idx < kHistSize && ch.hist[idx] < 255) ch.hist[idx]++;

  uint8_t max_val = 0, max_pos = 0, unique = 0;
  const uint16_t hist_len =
      (uint16_t)((ch.search_stop + 2 - ch.search_start) / ch.hist_step);
  for (uint8_t i = 0; i < hist_len && i < kHistSize; ++i) {
    if (ch.hist[i] > max_val) {
      max_val = ch.hist[i];
      max_pos = i;
    }
    if (ch.hist[i] > 0) unique++;
  }
  if (max_val < 2) return;
  float total = 0.0f;
  uint8_t nz = 0;
  for (uint8_t i = 0; i < hist_len && i < kHistSize; ++i) {
    if (ch.hist[i] > 0) {
      total += ch.hist[i];
      nz++;
    }
  }
  const float avr = nz ? total / (float)nz : 0.0f;
  if (avr < 0.01f) return;
  float ratio = (float)max_val / avr;
  if (unique == 1 && max_val > 3) ratio = 10.0f;
  if (ratio <= 3.2f) return;

  ch.found_code_phase =
      (uint16_t)(ch.search_start + max_pos * ch.hist_step);
  if (ch.acq_state == kAcqCodeSearch1) ch.acq_state = kAcqCodeSearch1Done;
  else if (ch.acq_state == kAcqCodeSearch2) ch.acq_state = kAcqCodeSearch2Done;
  else if (ch.acq_state == kAcqCodeSearch3) ch.acq_state = kAcqCodeSearch3Done;
}

// acquisition_process_channel (acquisition.c:134-190)
void acq_process_channel(FwChannel& ch, const uint8_t* data, Scratch& s,
                         uint32_t now) {
  if (ch.prn < 1) return;
  if (ch.acq_state == kAcqDone) return;
  if (ch.acq_state == kAcqFreqSearchRun) {
    acq_freq_search(ch, data, s);
    return;
  }
  if (ch.acq_state == kAcqCodeSearch1Done) {
    // start SEARCH2 (acquisition.c:151-172)
    std::memset(ch.hist, 0, sizeof(ch.hist));
    ch.search_start = (uint16_t)(ch.found_code_phase - kSearch2Width / 2);
    ch.search_stop = (uint16_t)(ch.found_code_phase + kSearch2Width / 2);
    if (ch.search_start > 2 * kPrnLen) ch.search_start = 0;
    if (ch.search_stop > 2 * kPrnLen) ch.search_stop = 2 * kPrnLen;
    ch.hist_step = kSearch2Width / kHistSize + 1;
    acq_buffers_reset(ch);
    ch.acq_start_timestamp = now;
    ch.acq_state = kAcqCodeSearch2;
    return;
  }
  if (ch.acq_state == kAcqCodeSearch3Done) {
    ch.acq_state = kAcqDone;
    // hand off to pre-track (tracking.c:52-72; started by the master)
    ch.code_search_start =
        (uint16_t)(ch.found_code_phase - kPreTrackZone / 2);
    ch.code_search_stop =
        (uint16_t)(ch.found_code_phase + kPreTrackZone / 2);
    if (ch.code_search_start > 2 * kPrnLen) ch.code_search_start = 0;
    if (ch.code_search_stop > 2 * kPrnLen) ch.code_search_stop = 2 * kPrnLen;
    ch.if_freq_offset_hz = (float)ch.found_freq_hz;
  }
  if (ch.acq_state == kAcqCodeSearch1 || ch.acq_state == kAcqCodeSearch2 ||
      ch.acq_state == kAcqCodeSearch3) {
    acq_code_phase_search(ch, data, s, now);
  }
}

// ---- nav word framing (nav_data.c:257-378 semantics) -------------------

uint8_t check_preamble(const uint8_t* buf, int inv) {
  for (int i = 0; i < 8; ++i) {
    if (buf[i] != (kPreamble[i] ^ inv)) return 0;
  }
  return 1;
}

uint8_t word_check_parity(FwChannel& ch) {
  // nav_data.c:433-453 (IS-GPS-200 parity; destructive D30 invert of
  // bits 1-24, as the firmware does before saving the word)
  uint8_t parity[6];
  const uint8_t D29 = ch.oldD29, D30 = ch.oldD30;
  uint8_t* d = ch.word_buf - 1;
  for (int i = 1; i < 25; ++i) d[i] ^= D30;
  parity[0] = D29 ^ d[1] ^ d[2] ^ d[3] ^ d[5] ^ d[6] ^ d[10] ^ d[11] ^
              d[12] ^ d[13] ^ d[14] ^ d[17] ^ d[18] ^ d[20] ^ d[23];
  parity[1] = D30 ^ d[2] ^ d[3] ^ d[4] ^ d[6] ^ d[7] ^ d[11] ^ d[12] ^
              d[13] ^ d[14] ^ d[15] ^ d[18] ^ d[19] ^ d[21] ^ d[24];
  parity[2] = D29 ^ d[1] ^ d[3] ^ d[4] ^ d[5] ^ d[7] ^ d[8] ^ d[12] ^
              d[13] ^ d[14] ^ d[15] ^ d[16] ^ d[19] ^ d[20] ^ d[22];
  parity[3] = D30 ^ d[2] ^ d[4] ^ d[5] ^ d[6] ^ d[8] ^ d[9] ^ d[13] ^
              d[14] ^ d[15] ^ d[16] ^ d[17] ^ d[20] ^ d[21] ^ d[23];
  parity[4] = D30 ^ d[1] ^ d[3] ^ d[5] ^ d[6] ^ d[7] ^ d[9] ^ d[10] ^
              d[14] ^ d[15] ^ d[16] ^ d[17] ^ d[18] ^ d[21] ^ d[22] ^
              d[24];
  parity[5] = D29 ^ d[3] ^ d[5] ^ d[6] ^ d[8] ^ d[9] ^ d[10] ^ d[11] ^
              d[13] ^ d[15] ^ d[19] ^ d[22] ^ d[23] ^ d[24];
  return std::memcmp(d + 25, parity, 6) == 0 ? 1 : 0;
}

// gps_nav_data_save_word_data role (nav_data.c:408-414): append the
// current (post-parity-invert) word to the subframe buffer
void save_word_data(FwChannel& ch) {
  if (ch.word_cnt >= 0 && ch.word_cnt < 10) {
    std::memcpy(ch.subframe_bits + 30 * ch.word_cnt, ch.word_buf, 30);
  }
}

// getbitu over a 0/1 byte array (nav_data_decode.c:145-152 semantics)
uint32_t getbitu_bits(const uint8_t* bits, int pos, int len) {
  uint32_t v = 0;
  for (int i = pos; i < pos + len; ++i) v = (v << 1) | (bits[i] & 1);
  return v;
}

// gps_nav_data_update_subframe_time (nav_data.c:356-378)
void update_subframe_time(FwChannel& ch, uint32_t now) {
  if (ch.accurate_swap_ok == 0) return;
  uint32_t accur_swap_time =
      (now / kCodesInBit) * kCodesInBit + ch.accurate_swap_time;
  int32_t diff_accur = (int32_t)(now - accur_swap_time);
  if (diff_accur < 0) {
    accur_swap_time -= kCodesInBit;
  }
  ch.subframe_cnt++;
  if (getenv("FW_RX_DEBUG"))
    fprintf(stderr,
            "[fwdbg] prn %d subframe now=%u accurate_swap_time=%u "
            "last_subframe_time=%u (prev %u)\n",
            ch.prn, now, ch.accurate_swap_time, accur_swap_time,
            ch.last_subframe_time);
  ch.last_subframe_time = accur_swap_time;
}

void words_detection(FwChannel& ch, uint8_t new_bit, uint32_t now) {
  if (ch.word_cnt == 0) {
    std::memmove(ch.word_buf, ch.word_buf + 1, 29);
    ch.word_buf[29] = new_bit;
    if (check_preamble(ch.word_buf, 0)) {
      ch.oldD29 = ch.word_buf[28];
      ch.oldD30 = ch.word_buf[29];
      save_word_data(ch);     // word 1 saved un-checked (nav_data.c:270)
      ch.word_cnt = 1;
      ch.word_bit_cnt = 0;
      ch.inv_preamble_cnt = 0;
    }
    if (!ch.polarity_found && ch.word_cnt == 0) {
      if (check_preamble(ch.word_buf, 1)) ch.inv_preamble_cnt++;
      if (ch.inv_preamble_cnt >= 2) ch.inv_polarity_flag = 1;
    }
    if (ch.polarity_found) {
      if (now - ch.word_detection_timestamp > 12000) {
        ch.word_detection_timestamp = now;
        ch.polarity_found = 0;
        ch.inv_polarity_flag = 0;
      }
    }
  } else {
    ch.word_buf[ch.word_bit_cnt++] = new_bit;
    if (ch.word_bit_cnt >= 30) {
      if (word_check_parity(ch)) {
        // save D29/D30 from the (inverted) word as the firmware's
        // save_word_data does post-parity (nav_data.c:427-428)
        ch.oldD29 = ch.word_buf[28];
        ch.oldD30 = ch.word_buf[29];
        save_word_data(ch);
        ch.word_cnt++;
        ch.word_bit_cnt = 0;
        ch.word_detection_timestamp = now;
        ch.polarity_found = 1;
        if (ch.word_cnt == 10) {
          ch.subframe_count++;
          // HOW TOW (nav_data_decode.c:58: getbitu(buff,30,17)*6.0)
          ch.tow_gpst = (double)getbitu_bits(ch.subframe_bits, 30, 17) * 6.0;
          // subframe-time ledger (nav_data.c:332-341)
          update_subframe_time(ch, now);
          ch.new_subframe_flag = 1;
          ch.word_cnt = 0;
          std::memset(ch.word_buf, 0, 30);
          std::memset(ch.subframe_bits, 0, sizeof(ch.subframe_bits));
        }
      } else {
        ch.word_cnt = 0;
        std::memset(ch.word_buf, 0, 30);
      }
    }
  }
}

void bits_extraction(FwChannel& ch, uint8_t short_bit, uint32_t now,
                     Outputs& out) {
  const uint32_t diff = now - ch.old_swap_time;
  const uint8_t reminder = (uint8_t)(diff % kCodesInBit);
  if (reminder < ch.old_reminder) {
    const uint8_t bit = ch.pos_cnt > ch.neg_cnt ? 1 : 0;
    if (out.bit_cnt < out.bit_cap) {
      // record the PRE-polarity bit (raw prompt-sign majority; the
      // inv_polarity_flag XOR is undone — the flag is constant within
      // a bit, nav_data.c:64-66).  The JAX scan emits the same raw
      // convention (nav/frame.py owns polarity), so the streams
      // compare bit-exactly with no mid-run flip when the firmware
      // (re-)discovers its polarity (nav_data.c:285-305).
      out.bits[out.bit_cnt] = (int8_t)(bit ^ (uint8_t)ch.inv_polarity_flag);
      // START epoch of the ended bit on the channel's 20 ms grid
      // (now - reminder is the boundary the bit ended at)
      out.bit_times[out.bit_cnt] =
          (int32_t)(now - reminder) - kCodesInBit;
      out.bit_cnt++;
    }
    words_detection(ch, bit, now);
    ch.pos_cnt = 0;
    ch.neg_cnt = 0;
  }
  if (short_bit) ch.pos_cnt++; else ch.neg_cnt++;
  ch.old_reminder = reminder;
}

// gps_nav_data_accurate_sync_detection (nav_data.c:145-218): correlation
// magnitude ratios locate the bit flip INSIDE the 4-epoch slot (the
// correlator is circular, so a mid-window flip attenuates rather than
// flips the output)
void accurate_sync_detection(FwChannel& ch) {
  const int16_t* rv = ch.raw_ip;
  uint8_t swap_pos = 0;
  if (abs(rv[1]) > abs(rv[0])) return;
  if (rv[3] == 0) return;
  const float whole_ratio = (float)abs(rv[0]) / (float)abs(rv[3]);
  if (whole_ratio > 1.5f || whole_ratio < 0.7f) return;
  const int16_t code_phase_prn = (int16_t)ch.code_phase_fine / 16;
  if (code_phase_prn < 0 || code_phase_prn > kPrnLen) return;
  if (code_phase_prn < kPrnLen / 4 || code_phase_prn > kPrnLen * 3 / 4) {
    if (rv[1] == 0) return;
    const float ratio_jump = (float)abs(rv[0]) / (float)abs(rv[1]);
    if (ratio_jump > 1.5f || ratio_jump < 0.7f) return;
    swap_pos = code_phase_prn < kPrnLen / 4 ? 2 : 1;
  } else {
    const uint16_t diff1 = (uint16_t)abs(rv[0] - rv[1]);
    const uint16_t diff2 = (uint16_t)abs(rv[2] - rv[3]);
    if (diff1 > diff2) {
      if (diff2 == 0) return;
      if ((float)diff1 / (float)diff2 < 2.5f) return;
      swap_pos = 1;
    } else {
      if (diff1 == 0) return;
      if ((float)diff2 / (float)diff1 < 2.5f) return;
      swap_pos = 2;
    }
  }
  if (swap_pos == 0) return;
  const uint32_t swap_timestamp = ch.slot_start_time + swap_pos;
  ch.accurate_swap_time = swap_timestamp % kCodesInBit;
  ch.accurate_swap_ok = 1;
}

// nav_data.c:46-138 per tracked epoch
void nav_analyse(FwChannel& ch, int index, int16_t new_i, uint32_t now,
                 Outputs& out) {
  uint8_t short_bit = new_i > 0 ? 1 : 0;
  if (ch.inv_polarity_flag) short_bit ^= 1;
  ch.tmp_nav[index] = short_bit;
  ch.raw_ip[index] = new_i;
  if (index == 0) ch.slot_start_time = now;
  if (ch.period_sync_ok == 1) bits_extraction(ch, short_bit, now, out);
  if (index < kTrackChLen - 1) return;

  int switches = 0, pol_change_pos = 0;
  uint8_t pol_old = ch.tmp_nav[0];
  for (int i = 1; i < kTrackChLen; ++i) {
    if (ch.tmp_nav[i] != pol_old) {
      switches++;
      pol_change_pos = i;
    }
    pol_old = ch.tmp_nav[i];
  }
  if (switches == 1) {
    const uint32_t swap_ts = ch.slot_start_time + (uint32_t)pol_change_pos;
    const uint8_t reminder =
        (uint8_t)((swap_ts - ch.old_swap_time) % kCodesInBit);
    if (reminder < 2 || reminder == kCodesInBit - 1) {
      if (ch.right_period_cnt < 10) ch.right_period_cnt++;
      if (ch.right_period_cnt > 8) {
        if (!ch.period_sync_ok && out.sync_ms < 0)
          out.sync_ms = (int32_t)swap_ts;
        ch.period_sync_ok = 1;
      }
    } else {
      if (ch.right_period_cnt > 0) ch.right_period_cnt--;
      if (ch.right_period_cnt < 3) ch.period_sync_ok = 0;
    }
    ch.old_swap_time = swap_ts;
    // accurate swap-time refinement (nav_data.c:131-136): a mid-slot
    // flip (two epochs each side) is the analysable geometry
    if (ch.period_sync_ok && pol_change_pos == 2) {
      accurate_sync_detection(ch);
    }
  }
}

// tracking.c:92-170 per tracked epoch (index 0..3)
void tracking_step(FwChannel& ch, const uint8_t* data, int index,
                   uint32_t now, Scratch& s, Outputs& out) {
  uint32_t diff_ticks = now - ch.prev_track_timestamp;
  ch.prev_track_timestamp = now;
  if (diff_ticks > 50) diff_ticks = 1;
  if (diff_ticks != 1)
    rewind_if_phase(&ch.if_freq_accum, ch.if_freq_offset_hz,
                    (int)(diff_ticks - 1));

  const int16_t fine = (int16_t)ch.code_phase_fine;
  const uint16_t offset_bits = (uint16_t)(fine & (kFineRatio - 1));
  generate_prn_data2(ch.prn_code, s.prn, offset_bits);
  shift_to_zero_freq(data, (uint8_t*)s.di, (uint8_t*)s.dq,
                     (float)kIfHz + ch.if_freq_offset_hz,
                     &ch.if_freq_accum);

  const uint16_t off_p = (uint16_t)(fine / kFineRatio);
  uint16_t off_e = (uint16_t)(off_p - 1);
  uint16_t off_l = (uint16_t)(off_p + 1);
  if (off_e >= 2 * kPrnLen) off_e = 2 * kPrnLen - 1;
  if (off_l >= 2 * kPrnLen) off_l = 0;

  int16_t IE, QE, IP, QP, IL, QL;
  correlation_iq(s.prn, s.di, s.dq, off_e, &IE, &QE);
  correlation_iq(s.prn, s.di, s.dq, off_p, &IP, &QP);
  correlation_iq(s.prn, s.di, s.dq, off_l, &IL, &QL);

  // DLL (tracking.c:333-393) — every slot
  {
    const int32_t e2 = (int32_t)IE * IE + (int32_t)QE * QE;
    const int32_t l2 = (int32_t)IL * IL + (int32_t)QL * QL;
    const float code_err = -((float)(e2 - l2) / (float)(e2 + l2));
    ch.code_phase_fine += kDll1C1 * (code_err - ch.dll_code_err) +
                          kDll1C2 * 0.001f * code_err;
    int wrapped = 0;
    if (ch.code_phase_fine < 0.0f) {
      ch.code_phase_fine =
          (float)(kPrnLen * 2 * kFineRatio) - ch.code_phase_fine;
      wrapped = 1;
    } else if (ch.code_phase_fine > (float)(kPrnLen * 2 * kFineRatio)) {
      ch.code_phase_fine -= (float)(kPrnLen * 2 * kFineRatio);
      wrapped = 1;
    }
    ch.dll_code_err = code_err;
    // code filter accumulation (tracking.c:371-385): a wrap inside the
    // window poisons the average, so mark it unusable until reset
    if (wrapped)
      ch.code_phase_fine_filt = -1.0f;
    else if (ch.code_phase_fine_filt >= 0.0f) {
      ch.code_phase_fine_filt += ch.code_phase_fine;
      ch.code_filt_cnt++;
    }
  }

  // PLL (tracking.c:175-209) — applied on slot 0 only
  {
    float err;
    if (IP > 0)
      err = atan2f((float)QP, (float)IP) / (float)M_PI;
    else
      err = (float)(atan2((double)-QP, (double)-IP) / M_PI);
    if (index == 0) {
      float diff_old = err - ch.pll_code_err;
      if (diff_old > (float)M_PI / 2) diff_old = (float)M_PI - diff_old;
      if (diff_old < -(float)M_PI / 2) diff_old = -(float)M_PI - diff_old;
      if (ch.period_sync_ok)
        ch.if_freq_offset_hz -= kPll2C1 * diff_old + kPll2C2 * 0.001f * err;
      else
        ch.if_freq_offset_hz -= kPll1C1 * diff_old + kPll1C2 * 0.001f * err;
      ch.pll_code_err = err;
    }
  }

  // watchdog (tracking.c:261-327)
  {
    ch.pll_check_buf[index] = IP;
    if (index == kTrackChLen - 1) {
      int switches = 0;
      int pol_old = ch.pll_check_buf[0] > 0 ? 1 : 0;
      for (int i = 1; i < kTrackChLen; ++i) {
        const int pol = ch.pll_check_buf[i] > 0 ? 1 : 0;
        if (pol != pol_old) switches++;
        pol_old = pol;
      }
      if (switches > 1) {
        if (++ch.pll_bad_cnt > 10) ch.pll_bad_cnt = 10;
      } else if (ch.pll_bad_cnt > 0) {
        ch.pll_bad_cnt--;
      }
      if (ch.pll_bad_cnt > 9) ch.pll_bad_master++;
      else if (ch.pll_bad_cnt == 0) ch.pll_bad_master = 0;
      if (ch.pll_bad_master > 80) {
        ch.pll_bad_master = 0;
        ch.pll_bad_cnt = 0;
        int16_t diff_hz, new_off;
        do {
          const uint16_t r = (uint16_t)(rand() % 500);
          new_off = (int16_t)(ch.found_freq_hz - r + 250);
          diff_hz = (int16_t)ch.if_freq_offset_hz - new_off;
        } while (abs(diff_hz) < 200);
        ch.if_freq_offset_hz = (float)new_off;
      }
    }
  }

  // FLL (tracking.c:214-256) — slot 0 only latches old I/Q
  if (index == 0) {
    ch.fll_old_i = IP;
    ch.fll_old_q = QP;
  } else {
    const float f1 = IP == 0 ? (float)M_PI / 2
                             : atanf((float)QP / (float)IP);
    const float f2 = ch.fll_old_i == 0
                         ? (float)M_PI / 2
                         : atanf((float)ch.fll_old_q / (float)ch.fll_old_i);
    float fd = f1 - f2;
    if (fd > (float)M_PI / 2) fd = (float)M_PI - fd;
    if (fd < -(float)M_PI / 2) fd = -(float)M_PI - fd;
    float od = fd - ch.fll_err;
    if (od > (float)M_PI / 2) od = (float)M_PI - od;
    if (od < -(float)M_PI / 2) od = -(float)M_PI - od;
    ch.if_freq_offset_hz -= kFll1C1 * 0.001f * od + kFll1C2 * 0.001f * fd;
    ch.fll_old_i = IP;
    ch.fll_old_q = QP;
    ch.fll_err = fd;
  }

  nav_analyse(ch, index, IP, now, out);

  if (index == 0 && out.traj_cnt < out.traj_cap) {
    out.cp_traj[out.traj_cnt] = ch.code_phase_fine;
    out.dop_traj[out.traj_cnt] = ch.if_freq_offset_hz;
    out.traj_times[out.traj_cnt] = (int32_t)now;
    out.traj_cnt++;
  }
}

// pre-track (tracking.c:398-499)
void pre_track_step(FwChannel& ch, const uint8_t* data, int index,
                    Scratch& s) {
  generate_prn_data2(ch.prn_code, s.prn, 0);
  shift_to_zero_freq(data, (uint8_t*)s.di, (uint8_t*)s.dq,
                     (float)kIfHz + ch.if_freq_offset_hz, nullptr);
  uint16_t start = (uint16_t)(ch.code_search_start + index * kPreTrackStep);
  uint16_t stop = (uint16_t)(start + kPreTrackStep);
  if (stop > 2 * kPrnLen) stop = 2 * kPrnLen;
  for (uint16_t idx = start; idx < stop; ++idx) {
    const int16_t c = correlation8(s.prn, s.di, s.dq, idx);
    if (c > (int16_t)ch.ptk_best_val) {
      ch.ptk_best_val = (uint16_t)c;
      ch.ptk_best_phase = idx;
    }
  }
  if (index == kTrackChLen - 1) {
    ch.pre_track_phases[ch.pre_track_count++] = ch.ptk_best_phase;
    if (ch.pre_track_count > kPreTrackPointsMax - 10) {
      // sort + longest chain of identical phases (tracking.c:459-499)
      uint16_t* p = ch.pre_track_phases;
      const int n = ch.pre_track_count;
      for (int i = 1; i < n; ++i) {  // insertion sort (qsort semantics)
        const uint16_t v = p[i];
        int j = i - 1;
        while (j >= 0 && p[j] > v) {
          p[j + 1] = p[j];
          --j;
        }
        p[j + 1] = v;
      }
      int chain = 0, max_chain = 0;
      uint16_t found = 0;
      for (int i = 1; i < n; ++i) {
        if (p[i] == p[i - 1]) {
          chain++;
        } else {
          if (chain > max_chain) {
            max_chain = chain;
            found = p[i - 1];
          }
          chain = 0;
        }
      }
      if (chain > max_chain) {
        max_chain = chain;
        found = p[n - 1];
      }
      if (found) {
        ch.code_phase_fine = (float)(found * kFineRatio);
        ch.state = 3;
      }
    }
    if (ch.pre_track_count >= kPreTrackPointsMax) {
      ch.pre_track_count = 0;
      std::memset(ch.pre_track_phases, 0, sizeof(ch.pre_track_phases));
    }
    ch.ptk_best_val = 0;
  }
}

// ---- GPS master (gps_master.c) -----------------------------------------

struct FwMaster {
  FwChannel* ch = nullptr;
  int n_ch = 0;
  int start_flag = 1;
  int need_acq = 1;
};

// gps_master_handling acquisition/tracking sequencing (gps_master.c:68-130)
void master_handling(FwMaster& m, uint32_t now) {
  if (m.start_flag) {
    m.start_flag = 0;
    acq_start_channel(m.ch[0]);
  }
  m.need_acq = 0;
  int need_f_search = 0;
  int code_search3_cnt = 0;
  for (int i = 0; i < m.n_ch; ++i) {
    if (m.ch[i].acq_state != kAcqDone) m.need_acq = 1;
    if (m.ch[i].acq_state < kAcqFreqSearchDone) need_f_search = 1;
    if (m.ch[i].acq_state == kAcqCodeSearch2Done) code_search3_cnt++;
  }
  // Starting freq search — one channel at a time (gps_master.c:91-104)
  if (m.need_acq == 1) {
    for (int i = 0; i < m.n_ch - 1; ++i) {
      if (m.ch[i].acq_state == kAcqFreqSearchDone &&
          m.ch[i + 1].acq_state == kAcqNeedFreqSearch) {
        acq_start_channel(m.ch[i + 1]);
        return;
      }
    }
  }
  // Start code search for all channels (gps_master.c:107-120)
  if (need_f_search == 0 && m.need_acq == 1) {
    for (int i = 0; i < m.n_ch; ++i) {
      if (m.ch[i].acq_state == kAcqFreqSearchDone)
        acq_start_code_search(m.ch[i], now);
      if (code_search3_cnt == m.n_ch)
        acq_start_code_search3(m.ch[i], now);
    }
  }
  // Acquisition done everywhere -> start tracking (gps_master.c:122-130)
  if (m.need_acq == 0) {
    for (int i = 0; i < m.n_ch; ++i) {
      if (m.ch[i].state == 0) m.ch[i].state = 2;  // NEED_PRE_TRACK role
    }
  }
}

struct MasterObsOut {
  int32_t* pr_times = nullptr;   // (pr_cap,)
  double* pr_m = nullptr;        // (n_ch, pr_cap) row-major
  double* tow_s = nullptr;       // (n_ch, pr_cap)
  int32_t pr_cap = 0, pr_cnt = 0;
};

// gps_master_code_phase_filter_reset (gps_master.c:376-388)
void master_filter_reset(FwMaster& m, uint32_t now) {
  for (int i = 0; i < m.n_ch; ++i) {
    m.ch[i].code_phase_fine_filt = 0.0f;
    m.ch[i].code_filt_cnt = 0;
    m.ch[i].filt_start_time_ms = now;
  }
}

// gps_master_filter_code_phase (gps_master.c:332-374): returns 0 if the
// filter window is not ready, else its duration in ms; on success the
// per-channel accumulators hold the window AVERAGE code phase
uint16_t master_filter_code_phase(FwMaster& m, uint32_t now) {
  int ready = 0;
  for (int i = 0; i < m.n_ch; ++i)
    if (m.ch[i].code_filt_cnt > kCodeFilterLen) ready++;
  if (ready < m.n_ch) return 0;
  int swap = 0;
  for (int i = 0; i < m.n_ch; ++i)
    if (m.ch[i].code_phase_fine_filt < -0.5f) swap++;
  if (swap) {
    master_filter_reset(m, now);
    return 0;
  }
  const uint32_t dur = now - m.ch[0].filt_start_time_ms;
  if (dur > 1000) {
    master_filter_reset(m, now);
    return 0;
  }
  for (int i = 0; i < m.n_ch; ++i)
    m.ch[i].code_phase_fine_filt /= (float)m.ch[i].code_filt_cnt;
  return (uint16_t)dur;
}

// gps_master_final_pseudorange_calc (gps_master.c:294-329), FILTERED
// path (ENABLE_CODE_FILTER=1, the config.h:36 production default — the
// JAX side compares with its own code filter enabled)
void final_pseudorange_calc(FwMaster& m, uint32_t curr_tick_time,
                            int32_t ref_time_diff_ms, uint32_t ref_time_ms,
                            int ref_idx) {
  for (int i = 0; i < m.n_ch; ++i) {
    FwChannel& c = m.ch[i];
    const int32_t diff_prn_ms =
        (int32_t)(c.last_subframe_time - ref_time_ms);
    double ch_diff_time_ms =
        (double)diff_prn_ms +
        (double)c.code_phase_fine_filt / ((double)kPrnLen * 16.0);
    // code wrap not yet reflected in a new subframe (gps_master.c:316-323)
    if (c.code_phase_swap_flag == 1) {
      double corr_ms = 1.0;
      if (c.if_freq_offset_hz < 0.0f) corr_ms = -1.0;
      ch_diff_time_ms = ch_diff_time_ms - corr_ms;
    }
    c.pseudorange_m = (kGpsOffsetTimeMs + ch_diff_time_ms) * kClightNorm;
    c.tow_s = m.ch[ref_idx].tow_gpst +
              ((double)(ref_time_diff_ms + i * kTrackChLen) / 1000.0);
  }
}

// gps_master_nav_handling (gps_master.c:159-286), dummy slot cadence
void master_nav_handling(FwMaster& m, uint32_t curr_tick_time,
                         MasterObsOut& obs) {
  int has_subframe_time_cnt = 0;
  int first_time_not_set_cnt = 0;
  int ref_idx = 0;
  uint32_t min_subframe_time = 0xFFFFFFFFu;
  uint32_t max_subframe_time = 0;
  uint16_t min_subframe_cnt = 0xFFFF;
  uint16_t max_subframe_cnt = 0;
  for (int i = 0; i < m.n_ch; ++i) {
    FwChannel& c = m.ch[i];
    if (c.last_subframe_time != 0) has_subframe_time_cnt++;
    if (c.first_subframe_time == 0) first_time_not_set_cnt++;
    if (c.last_subframe_time < min_subframe_time) {
      min_subframe_time = c.last_subframe_time;
      ref_idx = i;  // reference = min time = closest satellite
    }
    if (c.last_subframe_time > max_subframe_time)
      max_subframe_time = c.last_subframe_time;
    if (c.subframe_cnt < min_subframe_cnt) min_subframe_cnt = c.subframe_cnt;
    if (c.subframe_cnt > max_subframe_cnt) max_subframe_cnt = c.subframe_cnt;
  }
  if (min_subframe_time == 0) return;
  if (max_subframe_time - min_subframe_time > 100) return;
  if (has_subframe_time_cnt == m.n_ch &&
      first_time_not_set_cnt == m.n_ch) {
    // ZERO-moment latch — once (gps_master.c:203-215)
    for (int i = 0; i < m.n_ch; ++i) {
      m.ch[i].first_subframe_time = m.ch[i].last_subframe_time;
      m.ch[i].subframe_cnt = 0;
    }
  }
  if (m.ch[0].first_subframe_time == 0) return;

  const uint32_t ref_time_ms = m.ch[ref_idx].first_subframe_time +
                               (uint32_t)max_subframe_cnt * kSubframeMs;
  // code-phase swap detection (gps_master.c:228-247)
  for (int i = 0; i < m.n_ch; ++i) {
    FwChannel& c = m.ch[i];
    if (c.code_phase_swap_flag && c.new_subframe_flag) {
      c.new_subframe_flag = 0;
      c.code_phase_swap_flag = 0;
    }
    const float diff_f = fabsf(c.old_code_phase_fine - c.code_phase_fine);
    if (diff_f > ((float)kPrnLen * 16.0f / 2.0f))
      c.code_phase_swap_flag = 1;
    c.old_code_phase_fine = c.code_phase_fine;
  }
  int32_t ref_time_diff_ms =
      (int32_t)curr_tick_time - (int32_t)m.ch[ref_idx].last_subframe_time;
  if (ref_time_diff_ms < 0) ref_time_diff_ms %= kSubframeMs;

  // code filter (gps_master.c:259-276): pseudoranges only when every
  // channel's window is ready; the window AVERAGE represents the code
  // phase at the window CENTER, which the firmware acknowledges by
  // pulling ref_time_diff_ms back by half the duration (c:264-265)
  const uint16_t filt_dur = master_filter_code_phase(m, curr_tick_time);
  if (filt_dur < 1) return;
  ref_time_diff_ms -= filt_dur / 2;

  final_pseudorange_calc(m, curr_tick_time, ref_time_diff_ms, ref_time_ms,
                         ref_idx);
  master_filter_reset(m, curr_tick_time);
  if (obs.pr_cnt < obs.pr_cap) {
    // series timestamp = the epoch the filtered observation actually
    // represents (window center) — the same compensation the firmware
    // applies to tow_s, applied to the comparison time base
    obs.pr_times[obs.pr_cnt] = (int32_t)curr_tick_time - filt_dur / 2;
    for (int i = 0; i < m.n_ch; ++i) {
      obs.pr_m[(int64_t)i * obs.pr_cap + obs.pr_cnt] = m.ch[i].pseudorange_m;
      obs.tow_s[(int64_t)i * obs.pr_cap + obs.pr_cnt] = m.ch[i].tow_s;
    }
    obs.pr_cnt++;
  }
}

}  // namespace

extern "C" {

// Run the firmware-semantics single-channel receiver over a packed
// 1-bit capture.
//
// capture: n_ms * 2046 bytes (1023 uint16 LSB-first words per ms, the
// SPI wire format).  doppler_hint_hz plays the firmware's
// given_freq_offset_hz role (acquisition.c:72-79): a NON-zero value
// skips the frequency search exactly as a user hint in main.c:59-73; a
// ZERO value runs the full cold frequency search (that is also the
// firmware's convention — given_freq_offset_hz == 0 means no hint).
// Outputs: nav bits (PRE-polarity — raw prompt-sign majority, the JAX
// scan's convention; see bits_extraction) with their emission epoch,
// slot-0 code-phase/Doppler trajectories (fine units / Hz), counts,
// and milestone epochs.  Returns 0 on success.
int32_t fw_rx_run(const uint8_t* capture, int64_t n_ms, int32_t prn,
                  int32_t doppler_hint_hz,
                  int8_t* bits, int32_t* bit_times, int32_t bit_cap,
                  int32_t* n_bits,
                  float* cp_traj, float* dop_traj, int32_t* traj_times,
                  int32_t traj_cap, int32_t* n_traj,
                  int32_t* acq_code_phase, int32_t* track_start_ms,
                  int32_t* sync_ms, int32_t* n_subframes) {
  if (prn < 1 || prn > 32) return -1;
  FwChannel ch;
  ch.prn = prn;
  ca_code(prn, ch.prn_code);
  ch.given_freq_hz = (int16_t)doppler_hint_hz;
  Scratch s;
  std::memset(&s, 0, sizeof(s));
  Outputs out;
  out.bits = bits;
  out.bit_times = bit_times;
  out.bit_cap = bit_cap;
  out.cp_traj = cp_traj;
  out.dop_traj = dop_traj;
  out.traj_times = traj_times;
  out.traj_cap = traj_cap;
  srand(1);  // the watchdog kick's rand() — deterministic runs

  FwMaster m;
  m.ch = &ch;
  m.n_ch = 1;

  for (int64_t ms = 0; ms < n_ms; ++ms) {
    const uint8_t* data = capture + ms * (kWords * 2);
    master_handling(m, (uint32_t)ms);
    if (m.need_acq) {
      acq_process_channel(ch, data, s, (uint32_t)ms);
      continue;
    }
    // TDM: this channel owns superframe slots 0..3 (main.c:140-152)
    const int idx_big = (int)(ms % 17);
    if (idx_big >= kTrackChLen) continue;
    if (ch.state == 2) {
      pre_track_step(ch, data, idx_big, s);
      if (ch.state == 3) out.track_start_ms = (int32_t)ms;
    } else if (ch.state == 3) {
      tracking_step(ch, data, idx_big, (uint32_t)ms, s, out);
    }
  }
  *n_bits = out.bit_cnt;
  *n_traj = out.traj_cnt;
  *acq_code_phase = ch.acq_state == kAcqDone ? ch.found_code_phase : -1;
  *track_start_ms = out.track_start_ms;
  *sync_ms = out.sync_ms;
  *n_subframes = ch.subframe_count;
  return ch.state == 3 ? 0 : 1;
}

// Run the firmware-semantics MULTI-channel receiver (the gps_master
// role: staged acquisition sequencing, TDM tracking, subframe-time
// alignment with the ZERO-moment latch, relative pseudoranges) over a
// packed 1-bit capture — the observable-level parity oracle.
//
// hints[i] = 0 runs the cold frequency search on channel i
// (acquisition.c:280-416); non-zero skips it (main.c:59-73 hint path).
// Pseudoranges use the FILTERED firmware path (ENABLE_CODE_FILTER=1,
// the config.h:36 production default): gps_master.c:332-388 window
// averaging, emitted with the window-center timestamp the firmware
// itself compensates tow_s by.  Compare against the JAX receiver with
// its code filter enabled.  Outputs: per-channel acquisition results /
// milestones, per-channel nav-bit streams (pre-polarity, see
// fw_rx_run), and the relative pseudorange series appended at each
// dummy-slot nav handling whose filter window is ready (time,
// per-channel rho_m and tow_s).  Returns the number of channels that
// reached tracking.
int32_t fw_master_run(
    const uint8_t* capture, int64_t n_ms,
    const int32_t* prns, const int32_t* hints, int32_t n_ch,
    int32_t* found_freq_hz, int32_t* found_code_phase,
    int32_t* track_start_ms, int32_t* sync_ms, int32_t* n_subframes,
    int8_t* bits, int32_t* bit_times, int32_t bit_cap, int32_t* n_bits,
    float* cp_traj, float* dop_traj, int32_t* traj_times,
    int32_t traj_cap, int32_t* n_traj,
    int32_t* pr_times, double* pr_m, double* tow_s, int32_t pr_cap,
    int32_t* n_pr) {
  if (n_ch < 1 || n_ch > 12) return -1;
  FwChannel* chans = new FwChannel[n_ch];
  Outputs* outs = new Outputs[n_ch];
  for (int i = 0; i < n_ch; ++i) {
    if (prns[i] < 1 || prns[i] > 32) {
      delete[] chans;
      delete[] outs;
      return -1;
    }
    chans[i].prn = prns[i];
    ca_code(prns[i], chans[i].prn_code);
    chans[i].given_freq_hz = (int16_t)hints[i];
    outs[i].bits = bits + (int64_t)i * bit_cap;
    outs[i].bit_times = bit_times + (int64_t)i * bit_cap;
    outs[i].bit_cap = bit_cap;
    outs[i].cp_traj = cp_traj + (int64_t)i * traj_cap;
    outs[i].dop_traj = dop_traj + (int64_t)i * traj_cap;
    outs[i].traj_times = traj_times + (int64_t)i * traj_cap;
    outs[i].traj_cap = traj_cap;
  }
  Scratch s;
  std::memset(&s, 0, sizeof(s));
  srand(1);

  FwMaster m;
  m.ch = chans;
  m.n_ch = n_ch;
  MasterObsOut obs;
  obs.pr_times = pr_times;
  obs.pr_m = pr_m;
  obs.tow_s = tow_s;
  obs.pr_cap = pr_cap;

  const int frame_len = n_ch * kTrackChLen + 1;  // 17 for 4 ch (main.c:139)

  for (int64_t ms = 0; ms < n_ms; ++ms) {
    const uint8_t* data = capture + ms * (kWords * 2);
    const uint32_t now = (uint32_t)ms;
    if (m.need_acq) {
      // slow path (main.c:111-131): acquisition for all channels on
      // this snapshot, then master sequencing
      for (int i = 0; i < n_ch; ++i)
        acq_process_channel(chans[i], data, s, now);
      master_handling(m, now);
      continue;
    }
    // fast path (main.c:134-158): TDM schedule over the superframe
    const int idx_big = (int)(ms % frame_len);
    if (idx_big == frame_len - 1) {
      // dummy slot: nav handling + pseudoranges (gps_master.c:145-154)
      master_nav_handling(m, now, obs);
      master_handling(m, now);
      continue;
    }
    const int sat = idx_big / kTrackChLen;
    const int slot = idx_big % kTrackChLen;
    FwChannel& c = chans[sat];
    if (c.state == 2) {
      pre_track_step(c, data, slot, s);
      if (c.state == 3) outs[sat].track_start_ms = (int32_t)ms;
    } else if (c.state == 3) {
      tracking_step(c, data, slot, now, s, outs[sat]);
    }
    master_handling(m, now);
  }
  int tracking_cnt = 0;
  for (int i = 0; i < n_ch; ++i) {
    found_freq_hz[i] =
        chans[i].acq_state >= kAcqFreqSearchDone ? chans[i].found_freq_hz
                                                 : -100000;
    found_code_phase[i] =
        chans[i].acq_state == kAcqDone ? chans[i].found_code_phase : -1;
    track_start_ms[i] = outs[i].track_start_ms;
    sync_ms[i] = outs[i].sync_ms;
    n_subframes[i] = chans[i].subframe_count;
    n_bits[i] = outs[i].bit_cnt;
    n_traj[i] = outs[i].traj_cnt;
    if (chans[i].state == 3) tracking_cnt++;
  }
  *n_pr = obs.pr_cnt;
  delete[] chans;
  delete[] outs;
  return tracking_cnt;
}

}  // extern "C"
