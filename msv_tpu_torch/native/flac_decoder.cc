// Native FLAC decoder (no external codec library in this image).
//
// The reference decodes FLAC through rodio/claxon (src_rust/audio.rs:23-30,
// codec enabled at Cargo.toml:18).  This is an independent from-scratch
// implementation of the FLAC bitstream (RFC 9639): STREAMINFO metadata,
// frame headers with CRC-8 verification, constant / verbatim / fixed /
// LPC subframes, 4- and 5-bit Rice partitioned residuals (incl. escape
// partitions), wasted bits, and left/right/mid-side stereo decorrelation,
// with frame CRC-16 verification.  Output is channel-major float32
// normalized by 2^(bps-1), matching the int-PCM normalization the
// reference applies to WAV (audio.rs:15-19) and what rodio emits for FLAC.
//
// Build: make -C msv_tpu/native   (part of libmsv_native.so)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------- CRC ----
uint8_t crc8(const uint8_t* p, size_t n) {  // poly x^8+x^2+x+1 (0x07)
  uint8_t c = 0;
  for (size_t i = 0; i < n; i++) {
    c ^= p[i];
    for (int b = 0; b < 8; b++) c = (c & 0x80) ? (uint8_t)((c << 1) ^ 0x07) : (uint8_t)(c << 1);
  }
  return c;
}

uint16_t crc16(const uint8_t* p, size_t n) {  // poly 0x8005
  uint16_t c = 0;
  for (size_t i = 0; i < n; i++) {
    c ^= (uint16_t)p[i] << 8;
    for (int b = 0; b < 8; b++)
      c = (c & 0x8000) ? (uint16_t)((c << 1) ^ 0x8005) : (uint16_t)(c << 1);
  }
  return c;
}

// --------------------------------------------------------- bit reader ----
struct BitReader {
  const uint8_t* p;
  size_t n;       // total bytes
  size_t byte = 0;
  int bit = 0;    // bits consumed in current byte (0..7)
  bool ok = true;

  size_t bits_left() const { return ok ? (n - byte) * 8 - bit : 0; }

  uint32_t read_bits(int k) {  // k <= 32
    uint64_t v = 0;
    while (k > 0 && ok) {
      if (byte >= n) { ok = false; return 0; }
      int avail = 8 - bit;
      int take = k < avail ? k : avail;
      uint32_t cur = (uint32_t)(p[byte] >> (avail - take)) & ((1u << take) - 1);
      v = (v << take) | cur;
      bit += take;
      if (bit == 8) { bit = 0; byte++; }
      k -= take;
    }
    return (uint32_t)v;
  }

  uint64_t read_bits64(int k) {
    uint64_t hi = 0;
    if (k > 32) { hi = read_bits(k - 32); k = 32; }
    return (hi << k) | read_bits(k);
  }

  int64_t read_signed(int k) {  // two's complement
    if (k == 0) return 0;
    uint64_t v = read_bits64(k);
    uint64_t sign = 1ull << (k - 1);
    return (int64_t)((v ^ sign)) - (int64_t)sign;
  }

  uint32_t read_unary() {  // count 0s until a 1
    uint32_t q = 0;
    while (ok) {
      if (byte >= n) { ok = false; return 0; }
      uint8_t rest = (uint8_t)(p[byte] << bit);
      if (rest == 0) { q += 8 - bit; bit = 0; byte++; continue; }
      int lead = __builtin_clz((uint32_t)rest << 24);
      q += lead;
      bit += lead + 1;
      if (bit >= 8) { bit -= 8; byte++; }
      return q;
    }
    return 0;
  }

  void align_byte() { if (bit) { bit = 0; byte++; } }
};

// --------------------------------------------------------------- FLAC ----
struct StreamInfo {
  uint32_t sample_rate = 0;
  int channels = 0;
  int bps = 0;
  uint64_t total_samples = 0;
  uint32_t min_block = 0, max_block = 0;
};

// UTF-8-style coded number (frame/sample index), up to 36 bits + 56-bit form.
bool read_utf8_num(BitReader& br, uint64_t* out) {
  uint32_t b0 = br.read_bits(8);
  if (!br.ok) return false;
  int extra;
  uint64_t v;
  if ((b0 & 0x80) == 0) { *out = b0; return true; }
  else if ((b0 & 0xE0) == 0xC0) { extra = 1; v = b0 & 0x1F; }
  else if ((b0 & 0xF0) == 0xE0) { extra = 2; v = b0 & 0x0F; }
  else if ((b0 & 0xF8) == 0xF0) { extra = 3; v = b0 & 0x07; }
  else if ((b0 & 0xFC) == 0xF8) { extra = 4; v = b0 & 0x03; }
  else if ((b0 & 0xFE) == 0xFC) { extra = 5; v = b0 & 0x01; }
  else if (b0 == 0xFE) { extra = 6; v = 0; }
  else return false;
  for (int i = 0; i < extra; i++) {
    uint32_t b = br.read_bits(8);
    if (!br.ok || (b & 0xC0) != 0x80) return false;
    v = (v << 6) | (b & 0x3F);
  }
  *out = v;
  return true;
}

bool decode_residual(BitReader& br, int blocksize, int order,
                     std::vector<int64_t>& x) {
  uint32_t method = br.read_bits(2);
  if (!br.ok || method > 1) return false;
  int pbits = method == 0 ? 4 : 5;
  uint32_t escape = method == 0 ? 0xF : 0x1F;
  uint32_t po = br.read_bits(4);
  uint32_t nparts = 1u << po;
  if ((uint32_t)blocksize % nparts != 0) return false;
  int idx = order;
  for (uint32_t part = 0; part < nparts; part++) {
    int count = (int)((uint32_t)blocksize >> po);
    if (part == 0) count -= order;
    if (count < 0) return false;
    uint32_t param = br.read_bits(pbits);
    if (!br.ok) return false;
    if (param == escape) {
      uint32_t raw = br.read_bits(5);
      for (int i = 0; i < count; i++)
        x[idx++] = raw ? br.read_signed(raw) : 0;
    } else {
      for (int i = 0; i < count; i++) {
        uint32_t q = br.read_unary();
        uint32_t r = param ? br.read_bits(param) : 0;
        uint64_t u = ((uint64_t)q << param) | r;
        x[idx++] = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);  // zigzag
      }
    }
    if (!br.ok) return false;
  }
  return idx == blocksize;
}

bool decode_subframe(BitReader& br, int blocksize, int bps,
                     std::vector<int64_t>& x) {
  x.assign(blocksize, 0);
  if (br.read_bits(1) != 0) return false;  // mandatory pad bit
  uint32_t type = br.read_bits(6);
  uint32_t wasted = 0;
  if (br.read_bits(1)) wasted = br.read_unary() + 1;
  if (!br.ok) return false;
  int ebps = bps - (int)wasted;
  if (ebps <= 0 || ebps > 33) return false;

  if (type == 0) {  // CONSTANT
    int64_t v = br.read_signed(ebps);
    for (int i = 0; i < blocksize; i++) x[i] = v;
  } else if (type == 1) {  // VERBATIM
    for (int i = 0; i < blocksize; i++) x[i] = br.read_signed(ebps);
  } else if (type >= 8 && type <= 12) {  // FIXED, order 0-4
    int order = (int)type - 8;
    if (order > blocksize) return false;
    for (int i = 0; i < order; i++) x[i] = br.read_signed(ebps);
    if (!decode_residual(br, blocksize, order, x)) return false;
    for (int i = order; i < blocksize; i++) {
      switch (order) {
        case 0: break;
        case 1: x[i] += x[i - 1]; break;
        case 2: x[i] += 2 * x[i - 1] - x[i - 2]; break;
        case 3: x[i] += 3 * x[i - 1] - 3 * x[i - 2] + x[i - 3]; break;
        case 4: x[i] += 4 * x[i - 1] - 6 * x[i - 2] + 4 * x[i - 3] - x[i - 4]; break;
      }
    }
  } else if (type >= 32) {  // LPC, order 1-32
    int order = (int)(type & 0x1F) + 1;
    if (order > blocksize) return false;
    for (int i = 0; i < order; i++) x[i] = br.read_signed(ebps);
    uint32_t prec = br.read_bits(4);
    if (!br.ok || prec == 15) return false;
    int precision = (int)prec + 1;
    int shift = (int)br.read_signed(5);
    if (shift < 0) return false;  // spec: shall not be negative
    int64_t coef[32];
    for (int i = 0; i < order; i++) coef[i] = br.read_signed(precision);
    if (!decode_residual(br, blocksize, order, x)) return false;
    for (int i = order; i < blocksize; i++) {
      int64_t acc = 0;
      for (int j = 0; j < order; j++) acc += coef[j] * x[i - 1 - j];
      x[i] += acc >> shift;
    }
  } else {
    return false;  // reserved type
  }
  if (!br.ok) return false;
  if (wasted)
    for (int i = 0; i < blocksize; i++) x[i] <<= wasted;
  return true;
}

static const uint32_t kRateFromCode[] = {0,     88200, 176400, 192000,
                                         8000,  16000, 22050,  24000,
                                         32000, 44100, 48000,  96000};

int decode_flac(const uint8_t* data, size_t n, float** out_buf,
                int64_t* out_samples, int32_t* out_ch, int32_t* out_sr,
                int32_t** out_int = nullptr, int32_t* out_bps = nullptr) {
  if (n < 8 || memcmp(data, "fLaC", 4) != 0) return 2;  // not FLAC
  size_t pos = 4;
  StreamInfo si;
  bool have_si = false;
  // metadata blocks
  for (;;) {
    if (pos + 4 > n) return 3;
    uint8_t hdr = data[pos];
    uint32_t len = ((uint32_t)data[pos + 1] << 16) |
                   ((uint32_t)data[pos + 2] << 8) | data[pos + 3];
    pos += 4;
    if (pos + len > n) return 3;
    if ((hdr & 0x7F) == 0 && len >= 34) {  // STREAMINFO
      const uint8_t* b = data + pos;
      si.min_block = ((uint32_t)b[0] << 8) | b[1];
      si.max_block = ((uint32_t)b[2] << 8) | b[3];
      si.sample_rate = ((uint32_t)b[10] << 12) | ((uint32_t)b[11] << 4) |
                       (b[12] >> 4);
      si.channels = ((b[12] >> 1) & 0x7) + 1;
      si.bps = (((b[12] & 1) << 4) | (b[13] >> 4)) + 1;
      si.total_samples = (((uint64_t)(b[13] & 0x0F)) << 32) |
                         ((uint64_t)b[14] << 24) | ((uint64_t)b[15] << 16) |
                         ((uint64_t)b[16] << 8) | b[17];
      have_si = true;
    }
    pos += len;
    if (hdr & 0x80) break;  // last metadata block
  }
  if (!have_si || si.sample_rate == 0 || si.channels < 1 || si.channels > 8)
    return 3;

  std::vector<std::vector<float>> out((size_t)si.channels);
  if (si.total_samples)
    for (auto& v : out) v.reserve((size_t)si.total_samples);
  // optional raw-integer output (units of 2^-(bps-1)); only meaningful
  // when every frame shares one bit depth (the overwhelmingly common case)
  bool want_int = out_int != nullptr && out_bps != nullptr;
  int int_bps = -1;
  std::vector<std::vector<int32_t>> outi(want_int ? (size_t)si.channels : 0);

  std::vector<int64_t> chan[8];
  uint64_t decoded = 0;

  while (pos + 2 <= n) {
    // frame sync: 11111111 111110xx
    if (data[pos] != 0xFF || (data[pos + 1] & 0xFC) != 0xF8) {
      // tolerate trailing garbage only if we already have all samples
      if (si.total_samples && decoded >= si.total_samples) break;
      return 4;
    }
    BitReader br{data + pos, n - pos};
    size_t hdr_start = 0;
    br.read_bits(14);                    // sync
    br.read_bits(1);                     // reserved
    br.read_bits(1);                     // blocking strategy
    uint32_t bs_code = br.read_bits(4);
    uint32_t sr_code = br.read_bits(4);
    uint32_t ch_code = br.read_bits(4);
    uint32_t ss_code = br.read_bits(3);
    br.read_bits(1);                     // reserved
    uint64_t num;
    if (!read_utf8_num(br, &num)) return 4;
    int blocksize;
    switch (bs_code) {
      case 0: return 4;
      case 1: blocksize = 192; break;
      case 2: case 3: case 4: case 5: blocksize = 576 << (bs_code - 2); break;
      case 6: blocksize = (int)br.read_bits(8) + 1; break;
      case 7: blocksize = (int)br.read_bits(16) + 1; break;
      default: blocksize = 256 << (bs_code - 8); break;
    }
    uint32_t rate;
    if (sr_code == 0) rate = si.sample_rate;
    else if (sr_code < 12) rate = kRateFromCode[sr_code];
    else if (sr_code == 12) rate = br.read_bits(8) * 1000;
    else if (sr_code == 13) rate = br.read_bits(16);
    else if (sr_code == 14) rate = br.read_bits(16) * 10;
    else return 4;
    (void)rate;
    int n_ch;
    int side = -1;  // 0: left/side, 1: right/side, 2: mid/side
    if (ch_code <= 7) n_ch = (int)ch_code + 1;
    else if (ch_code <= 10) { n_ch = 2; side = (int)ch_code - 8; }
    else return 4;
    if (n_ch != si.channels) return 4;
    int bps;
    switch (ss_code) {
      case 0: bps = si.bps; break;
      case 1: bps = 8; break;
      case 2: bps = 12; break;
      case 4: bps = 16; break;
      case 5: bps = 20; break;
      case 6: bps = 24; break;
      case 7: bps = 32; break;
      default: return 4;
    }
    // CRC-8 over the header bytes consumed so far
    size_t hdr_bytes = br.byte + (br.bit ? 1 : 0);
    // header ends on a byte boundary before the CRC byte
    if (br.bit != 0) return 4;
    uint8_t want_crc8 = (uint8_t)br.read_bits(8);
    if (crc8(data + pos + hdr_start, hdr_bytes) != want_crc8) return 5;
    if (!br.ok) return 4;

    for (int ch = 0; ch < n_ch; ch++) {
      int sub_bps = bps;
      if (side == 0 && ch == 1) sub_bps++;  // left/side: side is ch 1
      if (side == 1 && ch == 0) sub_bps++;  // right/side: side is ch 0
      if (side == 2 && ch == 1) sub_bps++;  // mid/side: side is ch 1
      if (!decode_subframe(br, blocksize, sub_bps, chan[ch])) return 6;
    }
    br.align_byte();
    uint16_t want_crc16 = (uint16_t)br.read_bits(16);
    if (!br.ok) return 4;
    if (crc16(data + pos, br.byte - 2) != want_crc16) return 7;

    // stereo decorrelation
    if (side == 0) {        // left/side: right = left - side
      for (int i = 0; i < blocksize; i++)
        chan[1][i] = chan[0][i] - chan[1][i];
    } else if (side == 1) { // right/side: left = right + side
      for (int i = 0; i < blocksize; i++)
        chan[0][i] = chan[1][i] + chan[0][i];
    } else if (side == 2) { // mid/side
      for (int i = 0; i < blocksize; i++) {
        int64_t mid = (chan[0][i] << 1) | (chan[1][i] & 1);
        int64_t sd = chan[1][i];
        chan[0][i] = (mid + sd) >> 1;
        chan[1][i] = (mid - sd) >> 1;
      }
    }

    uint64_t want = blocksize;
    if (si.total_samples && decoded + want > si.total_samples)
      want = si.total_samples - decoded;  // last frame may be padded
    float scale = 1.0f / (float)(1ull << (bps - 1));
    for (int ch = 0; ch < n_ch; ch++)
      for (uint64_t i = 0; i < want; i++)
        out[(size_t)ch].push_back((float)chan[ch][i] * scale);
    if (want_int) {
      if (int_bps == -1) int_bps = bps;
      if (bps != int_bps) {
        want_int = false;  // mixed bit depths: int view is ill-defined
        outi.clear();
      } else {
        for (int ch = 0; ch < n_ch; ch++)
          for (uint64_t i = 0; i < want; i++)
            outi[(size_t)ch].push_back((int32_t)chan[ch][i]);
      }
    }
    decoded += want;
    pos += br.byte;
    if (si.total_samples && decoded >= si.total_samples) break;
  }

  if (decoded == 0) return 4;
  if (si.total_samples && decoded < si.total_samples) return 8;

  size_t per_ch = out[0].size();
  float* buf = (float*)malloc(sizeof(float) * per_ch * (size_t)si.channels);
  if (!buf) return 9;
  for (int ch = 0; ch < si.channels; ch++)
    memcpy(buf + (size_t)ch * per_ch, out[(size_t)ch].data(),
           sizeof(float) * per_ch);
  *out_buf = buf;
  *out_samples = (int64_t)per_ch;
  *out_ch = si.channels;
  *out_sr = (int32_t)si.sample_rate;
  if (out_int) *out_int = nullptr;
  if (out_bps) *out_bps = 0;
  if (want_int && int_bps > 0) {
    int32_t* ibuf =
        (int32_t*)malloc(sizeof(int32_t) * per_ch * (size_t)si.channels);
    if (ibuf) {
      for (int ch = 0; ch < si.channels; ch++)
        memcpy(ibuf + (size_t)ch * per_ch, outi[(size_t)ch].data(),
               sizeof(int32_t) * per_ch);
      *out_int = ibuf;
      *out_bps = int_bps;
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// rc: 0 ok, 1 io error, 2 not flac, 3 bad metadata, 4 bad frame,
//     5 header crc mismatch, 6 bad subframe, 7 frame crc mismatch,
//     8 truncated stream, 9 oom
int32_t msv_flac_decode(const char* path, float** out_buf,
                        int64_t* out_samples, int32_t* out_ch,
                        int32_t* out_sr) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (sz <= 0) { fclose(f); return 1; }
  std::vector<uint8_t> data((size_t)sz);
  size_t got = fread(data.data(), 1, (size_t)sz, f);
  fclose(f);
  if (got != (size_t)sz) return 1;
  return decode_flac(data.data(), data.size(), out_buf, out_samples, out_ch,
                     out_sr);
}

// As msv_flac_decode, additionally returning the raw integer samples
// (units of 2^-(bps-1), channel-major) when the stream has one uniform
// bit depth — the session's integer-domain wire path consumes these.
int32_t msv_flac_decode_ex(const char* path, float** out_buf,
                           int64_t* out_samples, int32_t* out_ch,
                           int32_t* out_sr, int32_t** out_int,
                           int32_t* out_bps) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (sz <= 0) { fclose(f); return 1; }
  std::vector<uint8_t> data((size_t)sz);
  size_t got = fread(data.data(), 1, (size_t)sz, f);
  fclose(f);
  if (got != (size_t)sz) return 1;
  return decode_flac(data.data(), data.size(), out_buf, out_samples, out_ch,
                     out_sr, out_int, out_bps);
}

}  // extern "C"
