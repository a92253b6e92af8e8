// Native WAV decoder (the TPU-framework analogue of the reference's native
// audio layer: hound/rodio in src_rust/audio.rs).
//
// Decodes RIFF/WAVE (PCM 8/16/24/32-bit + IEEE float32/64) into a
// channel-major float32 buffer (n_channels, n_samples), int PCM normalized
// by 2^(bits-1) (audio.rs:15-19 semantics).  Exposed via a C ABI consumed
// by ctypes (msv_tpu/io/_native_audio.py); the numpy parser is the
// fallback and parity oracle (tests/test_audio.py).
//
// Build: make -C msv_tpu/native

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Reader {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;
  bool ok = true;

  bool need(size_t k) {
    if (pos + k > n) {
      ok = false;
      return false;
    }
    return true;
  }
  uint32_t u32() {
    if (!need(4)) return 0;
    uint32_t v = (uint32_t)p[pos] | ((uint32_t)p[pos + 1] << 8) |
                 ((uint32_t)p[pos + 2] << 16) | ((uint32_t)p[pos + 3] << 24);
    pos += 4;
    return v;
  }
  uint16_t u16() {
    if (!need(2)) return 0;
    uint16_t v = (uint16_t)p[pos] | ((uint16_t)p[pos + 1] << 8);
    pos += 2;
    return v;
  }
};

constexpr uint16_t kPcm = 0x0001;
constexpr uint16_t kFloat = 0x0003;
constexpr uint16_t kExtensible = 0xFFFE;

}  // namespace

extern "C" {

// Returns 0 on success.  On success *out is a malloc'd channel-major
// float32 buffer of n_channels * n_samples; free with msv_free.
int32_t msv_wav_decode(const char* path, float** out, int64_t* n_samples,
                       int32_t* n_channels, int32_t* sample_rate) {
  *out = nullptr;
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  std::fseek(f, 0, SEEK_END);
  long fsize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (fsize < 12) {
    std::fclose(f);
    return 2;
  }
  std::vector<uint8_t> data((size_t)fsize);
  if (std::fread(data.data(), 1, (size_t)fsize, f) != (size_t)fsize) {
    std::fclose(f);
    return 3;
  }
  std::fclose(f);

  if (std::memcmp(data.data(), "RIFF", 4) != 0 ||
      std::memcmp(data.data() + 8, "WAVE", 4) != 0)
    return 4;

  uint16_t fmt_tag = 0, n_ch = 0, bits = 0;
  uint32_t sr = 0;
  const uint8_t* payload = nullptr;
  size_t payload_len = 0;

  size_t pos = 12;
  while (pos + 8 <= data.size()) {
    const uint8_t* cid = data.data() + pos;
    Reader r{data.data(), data.size(), pos + 4};
    uint32_t size = r.u32();
    size_t body = pos + 8;
    if (body + size > data.size()) size = (uint32_t)(data.size() - body);
    if (std::memcmp(cid, "fmt ", 4) == 0 && size >= 16) {
      Reader fr{data.data(), data.size(), body};
      fmt_tag = fr.u16();
      n_ch = fr.u16();
      sr = fr.u32();
      fr.u32();  // byte rate
      fr.u16();  // block align
      bits = fr.u16();
      if (fmt_tag == kExtensible && size >= 26) {
        Reader er{data.data(), data.size(), body + 24};
        fmt_tag = er.u16();  // first 2 bytes of the SubFormat GUID
      }
    } else if (std::memcmp(cid, "data", 4) == 0) {
      payload = data.data() + body;
      payload_len = size;
    }
    pos = body + size + (size & 1);  // chunks are word-aligned
  }
  if (!payload || n_ch == 0) return 5;
  if (n_ch > 64) return 5;  // corrupt fmt (matches the python parser bound)

  size_t bytes_per = bits / 8;
  if (bytes_per == 0) return 6;
  size_t total = payload_len / (bytes_per * n_ch);
  float* buf = (float*)std::malloc(sizeof(float) * total * n_ch);
  if (!buf) return 7;

  // Channel-major layout: buf[ch * total + i] (audio.rs:33-35 strides).
  auto store = [&](size_t i, size_t ch, float v) { buf[ch * total + i] = v; };

  if (fmt_tag == kFloat && bits == 32) {
    for (size_t i = 0; i < total; ++i)
      for (size_t c = 0; c < n_ch; ++c) {
        float v;
        std::memcpy(&v, payload + (i * n_ch + c) * 4, 4);
        store(i, c, v);
      }
  } else if (fmt_tag == kFloat && bits == 64) {
    for (size_t i = 0; i < total; ++i)
      for (size_t c = 0; c < n_ch; ++c) {
        double v;
        std::memcpy(&v, payload + (i * n_ch + c) * 8, 8);
        store(i, c, (float)v);
      }
  } else if (fmt_tag == kPcm && bits == 16) {
    const float scale = 1.0f / 32768.0f;
    for (size_t i = 0; i < total; ++i)
      for (size_t c = 0; c < n_ch; ++c) {
        int16_t v;
        std::memcpy(&v, payload + (i * n_ch + c) * 2, 2);
        store(i, c, (float)v * scale);
      }
  } else if (fmt_tag == kPcm && bits == 8) {
    const float scale = 1.0f / 128.0f;
    for (size_t i = 0; i < total; ++i)
      for (size_t c = 0; c < n_ch; ++c)
        store(i, c, (float)((int)payload[i * n_ch + c] - 128) * scale);
  } else if (fmt_tag == kPcm && bits == 24) {
    const float scale = 1.0f / 8388608.0f;
    for (size_t i = 0; i < total; ++i)
      for (size_t c = 0; c < n_ch; ++c) {
        const uint8_t* q = payload + (i * n_ch + c) * 3;
        int32_t v = (int32_t)q[0] | ((int32_t)q[1] << 8) | ((int32_t)q[2] << 16);
        if (v >= (1 << 23)) v -= (1 << 24);
        store(i, c, (float)v * scale);
      }
  } else if (fmt_tag == kPcm && bits == 32) {
    const float scale = 1.0f / 2147483648.0f;
    for (size_t i = 0; i < total; ++i)
      for (size_t c = 0; c < n_ch; ++c) {
        int32_t v;
        std::memcpy(&v, payload + (i * n_ch + c) * 4, 4);
        store(i, c, (float)v * scale);
      }
  } else {
    std::free(buf);
    return 8;
  }

  *out = buf;
  *n_samples = (int64_t)total;
  *n_channels = (int32_t)n_ch;
  *sample_rate = (int32_t)sr;
  return 0;
}

void msv_free(float* p) { std::free(p); }

}  // extern "C"
