// Native host runtime for the JAX GPS receiver: capture ingest.
//
// The firmware's ingest layer is SPI-slave DMA into a circular
// double-buffer with a guarded snapshot protocol
// (/root/reference/Firmware/project_main/signal_capture.c).  The
// host-side equivalent here feeds recorded 1-bit captures to the device
// pipeline at rates far above real time:
//
//  * LUT-based 1-bit word unpacking (uint16 LSB-first SPI words ->
//    +/-1 float samples), the hot host loop when replaying firmware
//    format captures;
//  * a popcount XOR correlator with the firmware's exact semantics
//    (gps_mult_and_summ/gps_correlation_iq, gps_misc.c:48-145) kept as
//    a bit-exact oracle for cross-checking the device kernels against
//    reference behavior;
//  * a single-producer single-consumer ring buffer for streaming
//    ingestion (the signal_capture double-buffer role, generalized).
//
// Built as a plain C ABI shared library, bound via ctypes
// (stm32f4_sdr_gps_tpu/runtime/native.py).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// 1-bit unpack/pack (capture.py pack_bits_lsb16 wire format)
// ---------------------------------------------------------------------------

// 256-entry LUT: byte -> 8 float samples (+1 for bit set, -1 clear),
// LSB first.  Built on first use.
static float g_unpack_lut[256][8];
static std::atomic<bool> g_lut_ready{false};

static void build_lut() {
  for (int b = 0; b < 256; ++b) {
    for (int i = 0; i < 8; ++i) {
      g_unpack_lut[b][i] = (b >> i) & 1 ? 1.0f : -1.0f;
    }
  }
  g_lut_ready.store(true, std::memory_order_release);
}

// words: n_words uint16 (LSB-first bit order); out: 16*n_words floats.
void sdr_unpack_bits16(const uint16_t* words, int64_t n_words, float* out) {
  if (!g_lut_ready.load(std::memory_order_acquire)) build_lut();
  for (int64_t w = 0; w < n_words; ++w) {
    const uint16_t v = words[w];
    std::memcpy(out + 16 * w, g_unpack_lut[v & 0xFF], 8 * sizeof(float));
    std::memcpy(out + 16 * w + 8, g_unpack_lut[v >> 8], 8 * sizeof(float));
  }
}

// signs: 16*n_words floats; out: n_words uint16, bit set where sign > 0.
void sdr_pack_bits16(const float* signs, int64_t n_words, uint16_t* out) {
  for (int64_t w = 0; w < n_words; ++w) {
    uint16_t v = 0;
    for (int i = 0; i < 16; ++i) {
      if (signs[16 * w + i] > 0.0f) v |= (uint16_t)(1u << i);
    }
    out[w] = v;
  }
}

// ---------------------------------------------------------------------------
// Firmware-semantics 1-bit correlator (oracle)
// ---------------------------------------------------------------------------

// XOR-popcount correlation of bit-packed I/Q streams against a packed
// replica at a byte offset, exactly gps_mult_and_summ + the
// (sum - BITS/2) centering of gps_correlation_iq (gps_misc.c:48-145).
// data_i/data_q/prn: length_bytes bytes each (byte-addressable halves of
// the uint16 words); offset in bytes with circular wrap; results are the
// centered signed sums.
void sdr_correlate_1bit(const uint8_t* data_i, const uint8_t* data_q,
                        const uint8_t* prn, int32_t length_bytes,
                        int32_t offset, int32_t* sum_i, int32_t* sum_q) {
  const int32_t total_bits = length_bytes * 8;
  int32_t ci = 0, cq = 0;
  for (int32_t b = 0; b < length_bytes; ++b) {
    const uint8_t p = prn[b];
    const int32_t src = (b + offset) % length_bytes;
    ci += __builtin_popcount((unsigned)(data_i[src] ^ p));
    cq += __builtin_popcount((unsigned)(data_q[src] ^ p));
  }
  *sum_i = ci - total_bits / 2;
  *sum_q = cq - total_bits / 2;
}

// Serial lag scan (correlation_search semantics, gps_misc.c:155-191):
// returns the argmax of sqrt(i^2+q^2) over [start, stop) byte offsets.
int32_t sdr_correlation_search(const uint8_t* data_i, const uint8_t* data_q,
                               const uint8_t* prn, int32_t length_bytes,
                               int32_t start, int32_t stop,
                               int32_t* best_val) {
  int32_t best = 0;
  int32_t best_off = start;
  for (int32_t off = start; off < stop; ++off) {
    int32_t si, sq;
    sdr_correlate_1bit(data_i, data_q, prn, length_bytes, off, &si, &sq);
    if (si < 0) si = 0;
    if (sq < 0) sq = 0;
    const int32_t mag2 = si * si + sq * sq;
    if (mag2 > best) {
      best = mag2;
      best_off = off;
    }
  }
  *best_val = best;
  return best_off;
}

// ---------------------------------------------------------------------------
// SPSC ring buffer for streaming sample blocks
// ---------------------------------------------------------------------------

struct SdrRing {
  std::vector<float> data;     // capacity floats (complex interleaved ok)
  int64_t capacity;
  std::atomic<int64_t> head;   // written (producer)
  std::atomic<int64_t> tail;   // consumed (consumer)
};

void* sdr_ring_create(int64_t capacity_floats) {
  auto* r = new SdrRing();
  r->data.resize(capacity_floats);
  r->capacity = capacity_floats;
  r->head.store(0);
  r->tail.store(0);
  return r;
}

void sdr_ring_destroy(void* ring) { delete static_cast<SdrRing*>(ring); }

int64_t sdr_ring_available(void* ring) {
  auto* r = static_cast<SdrRing*>(ring);
  return r->head.load(std::memory_order_acquire) -
         r->tail.load(std::memory_order_acquire);
}

int64_t sdr_ring_space(void* ring) {
  auto* r = static_cast<SdrRing*>(ring);
  return r->capacity - sdr_ring_available(ring);
}

// Push n floats; returns n on success, 0 if insufficient space (the
// caller decides whether to drop or retry — the firmware's equivalent
// failure is the >900 us stale-copy rejection, signal_capture.c:110-113).
int64_t sdr_ring_push(void* ring, const float* src, int64_t n) {
  auto* r = static_cast<SdrRing*>(ring);
  if (sdr_ring_space(ring) < n) return 0;
  int64_t head = r->head.load(std::memory_order_relaxed);
  for (int64_t i = 0; i < n; ++i) {
    r->data[(head + i) % r->capacity] = src[i];
  }
  r->head.store(head + n, std::memory_order_release);
  return n;
}

// Pop exactly n floats; returns n, or 0 if not enough data buffered.
int64_t sdr_ring_pop(void* ring, float* dst, int64_t n) {
  auto* r = static_cast<SdrRing*>(ring);
  if (sdr_ring_available(ring) < n) return 0;
  int64_t tail = r->tail.load(std::memory_order_relaxed);
  for (int64_t i = 0; i < n; ++i) {
    dst[i] = r->data[(tail + i) % r->capacity];
  }
  r->tail.store(tail + n, std::memory_order_release);
  return n;
}

}  // extern "C"
