// Host-side data-plane hot path (C++): the native analog of the reference's
// stream serializers (UARTTx/UARTRx shift registers + width adapters,
// generators/uart/UARTTx.scala:9-68, RxFftCfarMagTxChain.scala:27-46).
//
// Here the per-bit UART machinery becomes bulk host conversions that
// feed jax.device_put: packing interleaved int16 IQ into 32-bit beat words
// (real in [31:16], imag in [15:0] — RspChainTesterUtils.scala:105-109),
// unpacking beat words to float32 IQ pairs, and CRC32 framing integrity. These
// run on the ingest thread at wire rate and must not be Python loops.
//
// Built with: g++ -O3 -march=native -shared -fPIC packing.cpp -o libpacking.so
// Bound via ctypes (rsp_chains/io/native.py); a numpy fallback exists for
// environments without a toolchain.

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// interleaved int16 [re, im, re, im, ...] -> uint32 beat words (real in MSBs)
void pack_iq_i16(const int16_t* iq, uint32_t* words, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    uint16_t re = (uint16_t)iq[2 * i];
    uint16_t im = (uint16_t)iq[2 * i + 1];
    words[i] = ((uint32_t)re << 16) | (uint32_t)im;
  }
}

// uint32 beat words -> interleaved float32 [re, im, ...] (complex64 layout)
void unpack_iq_f32(const uint32_t* words, float* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    int16_t re = (int16_t)(words[i] >> 16);
    int16_t im = (int16_t)(words[i] & 0xFFFFu);
    out[2 * i] = (float)re;
    out[2 * i + 1] = (float)im;
  }
}

// interleaved float32 [re, im, ...] -> uint32 beat words with saturation to
// int16 range and round-half-up (the dsptools RoundHalfUp convention)
void pack_iq_f32(const float* iq, uint32_t* words, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    // round-half-up = floor(x + 0.5), matching dsptools RoundHalfUp
    int32_t r = (int32_t)floorf(iq[2 * i] + 0.5f);
    int32_t m = (int32_t)floorf(iq[2 * i + 1] + 0.5f);
    if (r > 32767) r = 32767;
    if (r < -32768) r = -32768;
    if (m > 32767) m = 32767;
    if (m < -32768) m = -32768;
    words[i] = ((uint32_t)(uint16_t)(int16_t)r << 16) | (uint32_t)(uint16_t)(int16_t)m;
  }
}

// CRC-32 (IEEE 802.3, reflected) over a byte buffer — frame integrity for the
// host link (the parity-bit analog, DSPBlockUART.scala:159-166)
namespace {
struct Crc32Table {
  uint32_t t[256];
  Crc32Table() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? (0xEDB88320u ^ (c >> 1)) : (c >> 1);
      t[i] = c;
    }
  }
};
// function-local static: C++11 guarantees thread-safe one-time construction,
// unlike the previous static-bool lazy init (racy under the server's
// per-connection threads)
const uint32_t* crc32_table() {
  static const Crc32Table tbl;
  return tbl.t;
}
}  // namespace

uint32_t crc32_ieee(const uint8_t* data, int64_t n, uint32_t seed) {
  const uint32_t* table = crc32_table();
  uint32_t crc = seed ^ 0xFFFFFFFFu;
  for (int64_t i = 0; i < n; ++i) crc = table[(crc ^ data[i]) & 0xFFu] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

// Scan a byte buffer for complete frames of the RSPC wire protocol
// (io/framing.py: 16-byte little-endian header {u32 magic, u32 seq,
// u32 n_words, u16 flags, u16 channel}, u32 payload words, u32 CRC-32 over
// header+payload). The RX hot path: one linear pass replaces a Python
// decode-attempt per byte during resync (the UART RX deserializer +
// majority-voter analog, UARTRx.scala:24-52 — corrupted input costs a scan,
// not an exception storm).
//
// meta[7*i..7*i+6] = {payload_byte_offset, n_words, seq, flags, channel,
//                     frame_total_bytes, frame_start_offset}
// returns the number of complete valid frames found (< max_frames);
// *consumed = resume offset for the next feed (start of the first incomplete
// frame, or the scan end); *skipped = bytes discarded during resync. Assumes
// a little-endian host (same as the Python struct '<' codecs).
int64_t scan_frames(const uint8_t* buf, int64_t len, int64_t max_words,
                    int64_t* meta, int64_t max_frames,
                    int64_t* consumed, int64_t* skipped) {
  const int64_t HDR = 16;
  const uint32_t MAGIC = 0x52535043u;
  int64_t pos = 0, nf = 0, skip = 0;
  while (len - pos >= HDR + 4 && nf < max_frames) {
    uint32_t magic;
    std::memcpy(&magic, buf + pos, 4);
    if (magic != MAGIC) { ++pos; ++skip; continue; }
    uint32_t n_words;
    std::memcpy(&n_words, buf + pos + 8, 4);
    if ((int64_t)n_words > max_words) { ++pos; ++skip; continue; }
    int64_t total = HDR + 4 * (int64_t)n_words + 4;
    if (len - pos < total) break;  // incomplete frame: resume here next feed
    uint32_t crc_stored;
    std::memcpy(&crc_stored, buf + pos + HDR + 4 * (int64_t)n_words, 4);
    if (crc32_ieee(buf + pos, HDR + 4 * (int64_t)n_words, 0) != crc_stored) {
      ++pos; ++skip; continue;  // one-byte resync, like the Python decoder
    }
    uint32_t seq;
    uint16_t flags, channel;
    std::memcpy(&seq, buf + pos + 4, 4);
    std::memcpy(&flags, buf + pos + 12, 2);
    std::memcpy(&channel, buf + pos + 14, 2);
    int64_t* m = meta + 7 * nf;
    m[0] = pos + HDR;
    m[1] = (int64_t)n_words;
    m[2] = (int64_t)seq;
    m[3] = (int64_t)flags;
    m[4] = (int64_t)channel;
    m[5] = total;
    m[6] = pos;
    pos += total;
    ++nf;
  }
  *consumed = pos;
  *skipped = skip;
  return nf;
}

// decode CFAR output words -> (threshold uint32, bin uint32, peak uint8) arrays
// (decode contract: RspChainVanillaTester.scala:164-172)
void unpack_cfar_words(const uint32_t* words, int64_t n, int bin_width,
                       uint32_t* threshold, uint32_t* bins, uint8_t* peaks) {
  const uint32_t bin_mask = (bin_width >= 32) ? 0xFFFFFFFFu : ((1u << bin_width) - 1u);
  for (int64_t i = 0; i < n; ++i) {
    uint32_t w = words[i];
    peaks[i] = (uint8_t)(w & 1u);
    bins[i] = (w >> 1) & bin_mask;
    threshold[i] = w >> (bin_width + 1);
  }
}

}  // extern "C"
