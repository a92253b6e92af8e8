// Device helpers shared by the two fused mel dB kernels:
// mel_spectrogram.cu (f32 parity mode) and mel_spectrogram_bf16.cu (bf16
// fast mode).  Both stage samples, compute the DFT magnitude of a tile of
// frequency bins into shared memory, then run the same sparse-band mel
// accumulation and the same dB epilogue; only the DFT bodies differ.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace msv {

constexpr int WARPS = 8;
constexpr float kAmin = 1e-18f;
constexpr float kDbScale = 8.685889638065036f;  // 20 / ln(10)
constexpr float kDbFloor = -360.0f;             // 20 * log10(1e-18)

__device__ __forceinline__ float load_sample(const float* p, long long i) {
  return p[i];
}

__device__ __forceinline__ float load_sample(const int16_t* p, long long i) {
  return static_cast<float>(p[i]) * 3.0517578125e-05f;  // exact 2^-15
}

__device__ __forceinline__ float to_f32(float x) { return x; }

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float load_weight(const float* p) {
  return __ldg(p);
}

__device__ __forceinline__ float load_weight(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// out[f][m] (+)= sum over band m's bins in tile [k0, k0 + kt) of
// mag[k - k0][f] * fb[k][m], for the TF frames of the block (nf valid).
// A Slaney band covers a contiguous run of bins (`bands` gives [lo, hi) per
// band), so only those bins are multiplied: about 2*n_freq FMAs a frame
// instead of n_freq*n_mel, and the skipped products are exact zeros.  Each
// (frame, band) sum has one owner thread, lane f % 32 of warp m % WARPS,
// adding bins in increasing order: no atomics and deterministic.  The tile
// holding a band's first bin stores, later tiles add.
template <int TF, typename MagT, typename FbT>
__device__ __forceinline__ void accumulate_bands(
    const MagT* mag, const FbT* __restrict__ fb, const int* __restrict__ bands,
    float* o, int k0, int kt, int n_freq, int n_mel, int nf, int lane,
    int warp) {
  constexpr int FPL = (TF + 31) / 32;  // frames per lane
  for (int m = warp; m < n_mel; m += WARPS) {
    const int lo = __ldg(bands + 2 * m);
    const int ks = max(lo, k0);
    const int ke = min(__ldg(bands + 2 * m + 1), min(k0 + kt, n_freq));
    if (ks >= ke) continue;
    float part[FPL];
#pragma unroll
    for (int h = 0; h < FPL; ++h) part[h] = 0.0f;
    for (int k = ks; k < ke; ++k) {
      const float wgt = load_weight(fb + static_cast<long long>(k) * n_mel + m);
#pragma unroll
      for (int h = 0; h < FPL; ++h) {
        const int f = h * 32 + lane;
        if (f < TF) {
          part[h] = fmaf(to_f32(mag[(k - k0) * TF + f]), wgt, part[h]);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < FPL; ++h) {
      const int f = h * 32 + lane;
      if (f < nf) {
        float* dst = o + static_cast<long long>(f) * n_mel + m;
        *dst = lo >= k0 ? part[h] : *dst + part[h];
      }
    }
  }
}

// The mel sums in `o` rewritten as dB, over the entries this thread owns:
// 20*ln(x)/ln(10) where x > 1e-18, else -360; bands with no support sum
// to 0.
template <int TF>
__device__ __forceinline__ void db_epilogue(float* o,
                                            const int* __restrict__ bands,
                                            int n_mel, int nf, int lane,
                                            int warp) {
  constexpr int FPL = (TF + 31) / 32;
  for (int m = warp; m < n_mel; m += WARPS) {
    const bool any = __ldg(bands + 2 * m) < __ldg(bands + 2 * m + 1);
#pragma unroll
    for (int h = 0; h < FPL; ++h) {
      const int f = h * 32 + lane;
      if (f < nf) {
        float* dst = o + static_cast<long long>(f) * n_mel + m;
        const float x = any ? *dst : 0.0f;
        *dst = x > kAmin ? logf(x) * kDbScale : kDbFloor;
      }
    }
  }
}

// The card's opt-in shared memory per block, from which each kernel picks
// the largest tile that fits.
inline int smem_optin_limit(size_t* cap) {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  *cap = static_cast<size_t>(limit);
  return static_cast<int>(err);
}

}  // namespace msv
