// airjax native runtime: C++ implementations of the host-side hot paths.
//
// The reference's entire binary is native (Rust); in airjax the
// compute path is JAX/XLA, and this library provides the native tier for
// the runtime *around* the device: capture IO, the block framer that feeds
// the device queue, a lock-free SPSC ring buffer for source->decode
// handoff, and a reference-exact scalar decoder used both as a high-speed
// host fallback and as an independent parity oracle (same semantics as
// /root/reference/src/adsb/demod.rs, crc.rs, utils.rs, re-derived from the
// protocol, not translated line-by-line).
//
// Exposed through a plain C ABI for ctypes (no pybind11 in this image).

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// c16 IO (reference src/utils.rs:7-43): little-endian i16 I,Q pairs.
// ---------------------------------------------------------------------------

// Returns number of complex samples, or -1 on error. Caller frees with
// airjax_free. *out receives an int16 buffer of 2*n values.
long long airjax_load_c16(const char* path, int16_t** out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long long bytes = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (bytes < 0 || bytes % 4 != 0) {
    std::fclose(f);
    return -1;
  }
  int16_t* buf = new (std::nothrow) int16_t[bytes / 2];
  if (!buf) {
    std::fclose(f);
    return -1;
  }
  size_t got = std::fread(buf, 1, (size_t)bytes, f);
  std::fclose(f);
  if ((long long)got != bytes) {
    delete[] buf;
    return -1;
  }
  *out = buf;
  return bytes / 4;
}

int airjax_save_c16(const char* path, const int16_t* data, long long n_samples) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  size_t wrote = std::fwrite(data, sizeof(int16_t), (size_t)(2 * n_samples), f);
  std::fclose(f);
  return wrote == (size_t)(2 * n_samples) ? 0 : -1;
}

void airjax_free(void* p) { delete[] (int16_t*)p; }

// ---------------------------------------------------------------------------
// Magnitude (reference src/utils.rs:46-52): trunc(sqrt(re^2+im^2)) as u32.
// ---------------------------------------------------------------------------

void airjax_magnitude(const int16_t* iq, long long n, uint32_t* out) {
  for (long long i = 0; i < n; ++i) {
    double re = (double)iq[2 * i];
    double im = (double)iq[2 * i + 1];
    out[i] = (uint32_t)std::sqrt(re * re + im * im);
  }
}

// ---------------------------------------------------------------------------
// CRC-24 (reference src/adsb/crc.rs:10-40), table-driven (byte at a time —
// same remainder as the reference's bit-serial long division).
// ---------------------------------------------------------------------------

static uint32_t crc_table[256];
static bool crc_table_ready = false;

static void crc_init() {
  const uint32_t poly = 0xFFF409;  // low 24 bits of the 25-bit generator
  for (int b = 0; b < 256; ++b) {
    uint32_t r = (uint32_t)b << 16;
    for (int i = 0; i < 8; ++i) {
      r = (r & 0x800000) ? ((r << 1) ^ poly) : (r << 1);
      r &= 0xFFFFFF;
    }
    crc_table[b] = r;
  }
  crc_table_ready = true;
}

uint32_t airjax_crc24(const uint8_t* data, int len) {
  if (!crc_table_ready) crc_init();
  uint32_t crc = 0;
  for (int i = 0; i < len; ++i) {
    crc = ((crc << 8) ^ crc_table[((crc >> 16) ^ data[i]) & 0xFF]) & 0xFFFFFF;
  }
  return crc;
}

// ---------------------------------------------------------------------------
// Scalar decoder (reference scan semantics: src/adsb.rs:92-122 ->
// demod.rs:17-57,65-131,180-201 -> crc.rs:49-65). Stride-1 over offsets
// [0, n-240), duplicates kept; single-bit CRC recovery over the 88 data
// bits (flips in the CRC field can never validate: the comparison is
// against the original packet CRC).
// ---------------------------------------------------------------------------

static const int kPreHighs[] = {0, 2, 7, 9};
static const int kPreLows[] = {1, 3, 4, 5, 6, 8, 10, 11, 12, 13, 14, 15};
static const int kDfHighs[] = {0, 3, 5, 7, 8};
static const int kDfLows[] = {1, 2, 4, 6, 9};

static bool check_preamble(const uint32_t* m) {
  for (int h : kPreHighs)
    for (int l : kPreLows)
      if (m[h] < m[l]) return false;
  for (int h : kDfHighs)
    for (int l : kDfLows)
      if (m[16 + h] < m[16 + l]) return false;
  return true;
}

static uint32_t syndromes[88];
static bool syndromes_ready = false;

static void syndromes_init() {
  for (int j = 0; j < 88; ++j) {
    uint8_t msg[11] = {0};
    msg[j / 8] = (uint8_t)(1u << (7 - j % 8));
    syndromes[j] = airjax_crc24(msg, 11);
  }
  syndromes_ready = true;
}

// Decode one candidate window (224 magnitudes). Returns 1 on CRC pass
// (packet filled), 2 on recovered single-bit flip, 0 otherwise.
static int decode_window(const uint32_t* m, uint8_t* packet) {
  uint8_t bytes[14] = {0};
  for (int k = 0; k < 112; ++k) {
    if (m[2 * k] > m[2 * k + 1]) bytes[k / 8] |= (uint8_t)(1u << (7 - k % 8));
  }
  uint32_t calced = airjax_crc24(bytes, 11);
  uint32_t packet_crc = ((uint32_t)bytes[11] << 16) | ((uint32_t)bytes[12] << 8) | bytes[13];
  if (calced == packet_crc) {
    std::memcpy(packet, bytes, 14);
    return 1;
  }
  if (!syndromes_ready) syndromes_init();
  uint32_t delta = calced ^ packet_crc;
  for (int j = 0; j < 88; ++j) {
    if (syndromes[j] == delta) {
      bytes[j / 8] ^= (uint8_t)(1u << (7 - j % 8));
      std::memcpy(packet, bytes, 14);
      return 2;
    }
  }
  return 0;
}

// Scan a chunk of IQ. Writes up to max_hits (offset, recovered) pairs and
// 14-byte packets. Returns the number of hits (clamped to max_hits);
// *n_detections gets the preamble-hit count.
long long airjax_decode_chunk(const int16_t* iq, long long n_samples,
                              long long* offsets_out, uint8_t* packets_out,
                              uint8_t* recovered_out, long long max_hits,
                              long long* n_detections) {
  if (n_samples < 240) {
    if (n_detections) *n_detections = 0;
    return 0;
  }
  std::vector<uint32_t> mags((size_t)n_samples);
  airjax_magnitude(iq, n_samples, mags.data());
  long long hits = 0, dets = 0;
  for (long long i = 0; i < n_samples - 240; ++i) {
    if (!check_preamble(&mags[(size_t)i])) continue;
    ++dets;
    uint8_t packet[14];
    int r = decode_window(&mags[(size_t)(i + 16)], packet);
    if (r && hits < max_hits) {
      offsets_out[hits] = i;
      recovered_out[hits] = (uint8_t)(r == 2);
      std::memcpy(packets_out + 14 * hits, packet, 14);
      ++hits;
    }
  }
  if (n_detections) *n_detections = dets;
  return hits;
}

// ---------------------------------------------------------------------------
// Extended-mode scalar decoder (extension; mirrors the classification of
// airjax.golden.decode_chunk_extended): preamble-only gate, then per
// candidate:
//   DF 16/20/21/24+     -> kind 3 (long AP candidate, icao = crc ^ field;
//                          dropped when the address is 0 — not a real
//                          aircraft, keeps all-zero streams from flooding)
//   DF >= 16 otherwise  -> kind 0 when CRC validates (1-bit recovery
//                          applied), else dropped
//   DF 11, PI == CRC    -> kind 1 (56-bit all-call)
//   DF 11, 0 < crc^pi < 80 -> kind 4 (interrogated all-call candidate;
//                          the residual is the II/SI interrogator code)
//   DF 0/4/5            -> kind 2 (short AP candidate, address 0 dropped)
// ---------------------------------------------------------------------------

static bool check_preamble_only(const uint32_t* m) {
  for (int h : kPreHighs)
    for (int l : kPreLows)
      if (m[h] < m[l]) return false;
  return true;
}

static long long decode_chunk_extended_impl(
    const int16_t* iq, long long n_samples, long long* offsets_out,
    uint8_t* kinds_out, uint8_t* packets_out, uint32_t* icao_ap_out,
    uint8_t* recovered_out, long long max_hits, long long* n_detections,
    int recover2) {
  if (n_samples < 240) {
    if (n_detections) *n_detections = 0;
    return 0;
  }
  std::vector<uint32_t> mags((size_t)n_samples);
  airjax_magnitude(iq, n_samples, mags.data());
  if (!syndromes_ready) syndromes_init();
  long long hits = 0, dets = 0;
  for (long long i = 0; i < n_samples - 240; ++i) {
    if (!check_preamble_only(&mags[(size_t)i])) continue;
    ++dets;
    if (hits >= max_hits) continue;
    const uint32_t* m = &mags[(size_t)(i + 16)];
    uint8_t bytes[14] = {0};
    for (int k = 0; k < 112; ++k) {
      if (m[2 * k] > m[2 * k + 1]) bytes[k / 8] |= (uint8_t)(1u << (7 - k % 8));
    }
    int df = bytes[0] >> 3;
    uint8_t kind = 0xFF, recovered = 0;
    uint32_t icao_ap = 0;
    if (df >= 16) {
      uint32_t calced = airjax_crc24(bytes, 11);
      uint32_t pcrc = ((uint32_t)bytes[11] << 16) | ((uint32_t)bytes[12] << 8) |
                      bytes[13];
      if (df == 16 || df == 20 || df == 21 || df >= 24) {
        icao_ap = calced ^ pcrc;
        if (icao_ap) kind = 3;
      } else if (calced == pcrc) {
        kind = 0;
      } else {
        uint32_t delta = calced ^ pcrc;
        for (int j = 0; j < 88; ++j) {
          if (syndromes[j] == delta) {
            bytes[j / 8] ^= (uint8_t)(1u << (7 - j % 8));
            kind = 0;
            recovered = 1;
            break;
          }
        }
        if (kind == 0xFF && recover2) {
          // Opt-in 2-flip repair (kind 5 = 'long2', pre-gate): the
          // pairwise syndrome table is collision-free (min distance 6)
          // so the first match is the unique one. O(88^2) per failed
          // candidate — scalar oracle, not a hot path.
          for (int j = 0; j < 88 && kind == 0xFF; ++j) {
            for (int k2 = j + 1; k2 < 88; ++k2) {
              if ((syndromes[j] ^ syndromes[k2]) == delta) {
                bytes[j / 8] ^= (uint8_t)(1u << (7 - j % 8));
                bytes[k2 / 8] ^= (uint8_t)(1u << (7 - k2 % 8));
                kind = 5;
                recovered = 2;
                break;
              }
            }
          }
        }
      }
    } else {
      uint32_t calced = airjax_crc24(bytes, 4);
      uint32_t pi = ((uint32_t)bytes[4] << 16) | ((uint32_t)bytes[5] << 8) |
                    bytes[6];
      if (df == 11 && calced == pi) {
        kind = 1;
      } else if (df == 11 && (calced ^ pi) < 80) {
        kind = 4;
        icao_ap = calced ^ pi;
      } else if (df == 0 || df == 4 || df == 5) {
        icao_ap = calced ^ pi;
        if (icao_ap) kind = 2;
      }
    }
    if (kind == 0xFF) continue;
    offsets_out[hits] = i;
    kinds_out[hits] = kind;
    icao_ap_out[hits] = icao_ap;
    recovered_out[hits] = recovered;
    std::memcpy(packets_out + 14 * hits, bytes, 14);
    ++hits;
  }
  if (n_detections) *n_detections = dets;
  return hits;
}

long long airjax_decode_chunk_extended(
    const int16_t* iq, long long n_samples, long long* offsets_out,
    uint8_t* kinds_out, uint8_t* packets_out, uint32_t* icao_ap_out,
    uint8_t* recovered_out, long long max_hits, long long* n_detections) {
  return decode_chunk_extended_impl(iq, n_samples, offsets_out, kinds_out,
                                    packets_out, icao_ap_out, recovered_out,
                                    max_hits, n_detections, 0);
}

// Opt-in 2-bit recovery variant (separate symbol: the base ABI stays
// stable for existing callers).
long long airjax_decode_chunk_extended_r2(
    const int16_t* iq, long long n_samples, long long* offsets_out,
    uint8_t* kinds_out, uint8_t* packets_out, uint32_t* icao_ap_out,
    uint8_t* recovered_out, long long max_hits, long long* n_detections) {
  return decode_chunk_extended_impl(iq, n_samples, offsets_out, kinds_out,
                                    packets_out, icao_ap_out, recovered_out,
                                    max_hits, n_detections, 1);
}

// ---------------------------------------------------------------------------
// Lock-free single-producer single-consumer ring buffer of fixed-size IQ
// blocks (the native replacement for the reference's mpsc channel,
// src/adsb.rs:131 — but bounded, so it backpressures instead of growing).
// ---------------------------------------------------------------------------

struct AirjaxRing {
  int16_t* storage;     // depth * block_samples * 2 int16
  long long* sizes;     // actual samples per slot
  long long block_samples;
  long long depth;
  std::atomic<long long> head;  // next write slot (producer)
  std::atomic<long long> tail;  // next read slot (consumer)
};

void* airjax_ring_create(long long block_samples, long long depth) {
  AirjaxRing* r = new AirjaxRing();
  r->storage = new int16_t[(size_t)(depth * block_samples * 2)];
  r->sizes = new long long[(size_t)depth];
  r->block_samples = block_samples;
  r->depth = depth;
  r->head.store(0);
  r->tail.store(0);
  return r;
}

void airjax_ring_destroy(void* ring) {
  AirjaxRing* r = (AirjaxRing*)ring;
  delete[] r->storage;
  delete[] r->sizes;
  delete r;
}

// Returns 1 on success, 0 if full (caller retries: backpressure).
int airjax_ring_push(void* ring, const int16_t* iq, long long n_samples) {
  AirjaxRing* r = (AirjaxRing*)ring;
  if (n_samples > r->block_samples) return 0;
  long long head = r->head.load(std::memory_order_relaxed);
  long long tail = r->tail.load(std::memory_order_acquire);
  if (head - tail >= r->depth) return 0;
  long long slot = head % r->depth;
  std::memcpy(r->storage + slot * r->block_samples * 2, iq,
              (size_t)(n_samples * 2 * sizeof(int16_t)));
  r->sizes[slot] = n_samples;
  r->head.store(head + 1, std::memory_order_release);
  return 1;
}

// Returns n_samples popped into out, or -1 if empty.
long long airjax_ring_pop(void* ring, int16_t* out) {
  AirjaxRing* r = (AirjaxRing*)ring;
  long long tail = r->tail.load(std::memory_order_relaxed);
  long long head = r->head.load(std::memory_order_acquire);
  if (tail >= head) return -1;
  long long slot = tail % r->depth;
  long long n = r->sizes[slot];
  std::memcpy(out, r->storage + slot * r->block_samples * 2,
              (size_t)(n * 2 * sizeof(int16_t)));
  r->tail.store(tail + 1, std::memory_order_release);
  return n;
}

long long airjax_ring_size(void* ring) {
  AirjaxRing* r = (AirjaxRing*)ring;
  return r->head.load(std::memory_order_acquire) -
         r->tail.load(std::memory_order_acquire);
}

}  // extern "C"
