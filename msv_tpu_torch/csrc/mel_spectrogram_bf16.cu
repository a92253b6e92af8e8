// Fused mel dB spectrogram for Hopper (sm_90a), bf16-operand fast mode.
//
// Replaces the fast mode of the TPU kernel msv_tpu/kernels/
// spectrogram_pallas.py::mel_spectrogram_pallas (both schedules with bf16
// C/S/fb operands, :145-156 and :209-219).  One launch computes, for every
// frame k of every batch row,
//
//   frame = bf16(padded[k*hop : k*hop + win])  (int16 input scaled by 2^-15
//                                                first, then rounded)
//   re = frame . C,  im = frame . S            (C, S: (win, n_freq) bf16,
//                                                f32 accumulation)
//   mel = bf16(sqrt(re^2 + im^2)) . fb         (fb: (n_freq, n_mel) bf16,
//                                                f32 accumulation)
//   dB  = 20*ln(mel)/ln(10) if mel > 1e-18 else -360
//
// Rounding is to nearest even (__float2bfloat16_rn), as the TPU casts.  A
// product of two bf16 values is exact in f32, so this is the function of
// the plain version (kernels/spectrogram_cuda.py::mel_spectrogram_plain,
// mode="fast"), up to f32 summation order.
//
// What bounds it on an H100: the DFT pair is 2*2*win*n_freq FLOPs a frame
// (7.9 MFLOP at 48 kHz), 92% of the work; an hour at 48 kHz is 2.8 TFLOP of
// it, against 345 MB of int16 read and 500 MB of f32 dB written, so HBM is
// not the ceiling.  C and S (7.9 MB in bf16 at 48 kHz) stay in L2 and every
// block re-reads them, 64 FLOPs per byte staged.  With one block per SM (the
// shared memory below), what bounds this design is the latency of staging
// each C/S slab from L2 between two barriers, not tensor-core issue: on an
// H100 80GB HBM3 at 700 W, 189 GFLOP at 48 kHz take 2.6 ms (73 TFLOP/s).
//
// What the design does about it (simple and right first; wgmma, TMA and a
// pipelined producer/consumer design are later work):
//  * One block per (tile of TF = 16*MT frames, batch row), 8 warps.  Each
//    warp owns all TF frames and 32 of the NB = 256 frequency columns of the
//    current tile, so every A fragment it loads feeds 4 n-tiles x 2
//    matrices of mma.sync.m16n8k16 (bf16 in, f32 accumulate): 8*MT
//    independent mma per 16 samples of K.
//  * The block stages its samples once, rounded to bf16.  Frame f starts at
//    sample f*hop, which for odd hops (221, 441) is an odd bf16 offset: no
//    ldmatrix and no aligned pair there.  So odd hops stage a second copy
//    shifted by one sample; a frame whose start is odd reads its sample
//    pairs from that copy, and every A register is one aligned 32-bit load.
//  * C and S are staged per 32-row K slab into shared memory at a padded
//    row stride (264 bf16 = 33 x 16 bytes, so the 8 rows an ldmatrix reads
//    fall in 8 different bank groups) and read as B fragments with
//    ldmatrix.x4.trans.  The global rows of C/S are n_freq (odd) wide, so
//    the staging uses 2-byte loads, all of a row's issued before its stores
//    so that they overlap.  Rows >= win and columns >= n_freq stage as
//    zeros, and only the active warps' columns are staged (the last tile of
//    n_freq = 2^k + 1 bins holds one bin).
//  * The magnitude is rounded to bf16 and stored per tile in shared memory;
//    the mel product then walks only each band's nonzero bins (the parity
//    kernel's sparse-band loop), one owner thread per (frame, band), adding
//    bins in increasing order: no atomics, deterministic, and the int16
//    route is bit-equal to the f32 route.  The mel sums accumulate in the
//    output buffer, which is rewritten as dB at the end (both are
//    mel_common.cuh's, shared with the parity kernel).
//  * MT (4, 2, then 1) is the largest whose shared memory fits the card.

#include "mel_common.cuh"

namespace {

using msv::WARPS;
constexpr int WCOLS = 32;           // frequency columns per warp
constexpr int NB = WARPS * WCOLS;   // frequency columns per tile
constexpr int KS = 32;              // C/S rows per shared-memory slab
constexpr int NBP = NB + 8;         // padded slab row stride (bf16)
using msv::ldmatrix_x4_trans;
using msv::mma_bf16;

// MT m-tiles of 16 frames per block; every warp covers all of them.
template <typename T, int MT>
__global__ void __launch_bounds__(32 * WARPS)
mel_db_bf16_kernel(const T* __restrict__ wave, long long wave_stride,
                   long long wave_len, const __nv_bfloat16* __restrict__ c,
                   const __nv_bfloat16* __restrict__ s,
                   const __nv_bfloat16* __restrict__ fb,
                   const int* __restrict__ bands, float* __restrict__ out,
                   int win, int hop, int n_frames, int n_freq, int n_mel,
                   int chunk_len) {
  constexpr int TF = 16 * MT;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(smem4);  // C, S slabs
  __nv_bfloat16* mag = cs + 2 * KS * NBP;                        // [NB][TF]
  __nv_bfloat16* chunk0 = mag + NB * TF;                         // samples
  __nv_bfloat16* chunk1 = chunk0 + chunk_len;  // shifted by 1 (odd hops)

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * 32 + lane;
  const int g = lane >> 2;   // mma group: fragment row / B column
  const int tig = lane & 3;  // thread in group: fragment column pair
  const int f0 = blockIdx.x * TF;
  const T* w = wave + static_cast<long long>(blockIdx.y) * wave_stride;
  const long long base = static_cast<long long>(f0) * hop;
  const bool odd = hop & 1;

  for (int i = tid; i < chunk_len; i += 32 * WARPS) {
    const long long gi = base + i;
    chunk0[i] =
        __float2bfloat16_rn(gi < wave_len ? msv::load_sample(w, gi) : 0.0f);
    if (odd) {
      chunk1[i] = __float2bfloat16_rn(
          gi + 1 < wave_len ? msv::load_sample(w, gi + 1) : 0.0f);
    }
  }
  // Row bases of this thread's A fragment rows (frames mt*16 + g and +8):
  // an even frame start reads chunk0, an odd one chunk1 one element back, so
  // every (n, n+1) pair with n even is one aligned 32-bit word.
  const __nv_bfloat16* arow[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = (mt * 16 + g + 8 * h) * hop;
      arow[mt][h] = (p & 1) ? chunk1 + (p - 1) : chunk0 + p;
    }
  }

  float* o = out + (static_cast<long long>(blockIdx.y) * n_frames + f0) * n_mel;
  const int nf = min(TF, n_frames - f0);
  const int wn0 = warp * WCOLS;  // this warp's first column in the tile

  for (int k0 = 0; k0 < n_freq; k0 += NB) {
    const bool active = k0 + wn0 < n_freq;  // warp-uniform
    // columns staged: the active warps' (the last tile of n_freq = 2^k + 1
    // bins holds one bin, so it stages one warp's 32 columns, not 256)
    const int ncols = min(NB, (n_freq - k0 + WCOLS - 1) / WCOLS * WCOLS);
    float re[MT][4][4], im[MT][4][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int q = 0; q < 4; ++q) re[mt][nt][q] = im[mt][nt][q] = 0.0f;
      }
    }

    for (int n0 = 0; n0 < win; n0 += KS) {
      __syncthreads();  // the previous slab (or tile's mel pass) is done
      // each warp stages rows warp, warp + WARPS, ...; a row's loads are
      // all issued before its stores, so 2 * NB / 32 loads are in flight
#pragma unroll
      for (int rr = 0; rr < KS / WARPS; ++rr) {
        const int r = warp + rr * WARPS;
        const int n = n0 + r;
        __nv_bfloat16 vc[NB / 32], vs[NB / 32];
#pragma unroll
        for (int j = 0; j < NB / 32; ++j) {
          const int col = lane + 32 * j;
          const int k = k0 + col;
          const bool ok = col < ncols && n < win && k < n_freq;
          const long long gi = static_cast<long long>(n) * n_freq + k;
          vc[j] = ok ? c[gi] : __float2bfloat16_rn(0.0f);
          vs[j] = ok ? s[gi] : __float2bfloat16_rn(0.0f);
        }
#pragma unroll
        for (int j = 0; j < NB / 32; ++j) {
          const int col = lane + 32 * j;
          if (col < ncols) {
            cs[r * NBP + col] = vc[j];
            cs[KS * NBP + r * NBP + col] = vs[j];
          }
        }
      }
      __syncthreads();
      if (active) {
#pragma unroll
        for (int kk = 0; kk < KS; kk += 16) {
          // B fragments of the warp's 4 n-tiles, for C and for S
          uint32_t bc[2][4], bs[2][4];
          const int brow = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
          for (int pr = 0; pr < 2; ++pr) {
            const int bcol = wn0 + pr * 16 + (lane >> 4) * 8;
            ldmatrix_x4_trans(bc[pr], cs + brow * NBP + bcol);
            ldmatrix_x4_trans(bs[pr], cs + KS * NBP + brow * NBP + bcol);
          }
          const int ka = n0 + kk + tig * 2;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            uint32_t a[4];
            a[0] = *reinterpret_cast<const uint32_t*>(arow[mt][0] + ka);
            a[1] = *reinterpret_cast<const uint32_t*>(arow[mt][1] + ka);
            a[2] = *reinterpret_cast<const uint32_t*>(arow[mt][0] + ka + 8);
            a[3] = *reinterpret_cast<const uint32_t*>(arow[mt][1] + ka + 8);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              const int pr = nt >> 1, hi = (nt & 1) * 2;
              mma_bf16(re[mt][nt], a, bc[pr][hi], bc[pr][hi + 1]);
              mma_bf16(im[mt][nt], a, bs[pr][hi], bs[pr][hi + 1]);
            }
          }
        }
      }
    }

    // |X| rounded to bf16 into mag[col][frame]
    if (active) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int col = wn0 + nt * 8 + tig * 2 + (q & 1);
            const int f = mt * 16 + g + (q >> 1) * 8;
            const float x = re[mt][nt][q], y = im[mt][nt][q];
            mag[col * TF + f] = __float2bfloat16_rn(sqrtf(x * x + y * y));
          }
        }
      }
    }
    __syncthreads();

    msv::accumulate_bands<TF>(mag, fb, bands, o, k0, NB, n_freq, n_mel, nf,
                              lane, warp);
  }
  msv::db_epilogue<TF>(o, bands, n_mel, nf, lane, warp);
}

// Staged samples per copy: frame TF-1's window rounded up to whole slabs,
// plus the pair read past it, rounded to 8 elements (16 bytes).
int chunk_elems(int mt, int win, int hop) {
  const int win_p = (win + KS - 1) / KS * KS;
  const long long n = static_cast<long long>(16 * mt - 1) * hop + win_p + 2;
  return static_cast<int>((n + 7) / 8 * 8);
}

size_t smem_bytes(int mt, int win, int hop) {
  const size_t copies = (hop & 1) ? 2 : 1;
  return sizeof(__nv_bfloat16) *
         (2 * static_cast<size_t>(KS) * NBP + static_cast<size_t>(NB) * 16 * mt +
          copies * chunk_elems(mt, win, hop));
}

template <typename T, int MT>
int launch_mt(const void* wave, long long wave_stride, long long wave_len,
              int batch, const __nv_bfloat16* c, const __nv_bfloat16* s,
              const __nv_bfloat16* fb, const int* bands, float* out, int win,
              int hop, int n_frames, int n_freq, int n_mel,
              cudaStream_t stream) {
  const size_t smem = smem_bytes(MT, win, hop);
  cudaError_t err = cudaFuncSetAttribute(
      mel_db_bf16_kernel<T, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tf = 16 * MT;
  const dim3 grid((n_frames + tf - 1) / tf, batch);
  const dim3 block(32, WARPS);
  mel_db_bf16_kernel<T, MT><<<grid, block, smem, stream>>>(
      static_cast<const T*>(wave), wave_stride, wave_len, c, s, fb, bands,
      out, win, hop, n_frames, n_freq, n_mel, chunk_elems(MT, win, hop));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* wave, long long wave_stride, long long wave_len,
           int batch, const __nv_bfloat16* c, const __nv_bfloat16* s,
           const __nv_bfloat16* fb, const int* bands, float* out, int win,
           int hop, int n_frames, int n_freq, int n_mel,
           cudaStream_t stream) {
  size_t cap = 0;
  if (const int err = msv::smem_optin_limit(&cap)) return err;
#define MSV_LAUNCH(M)                                                     \
  launch_mt<T, M>(wave, wave_stride, wave_len, batch, c, s, fb, bands,   \
                  out, win, hop, n_frames, n_freq, n_mel, stream)
  if (smem_bytes(4, win, hop) <= cap) return MSV_LAUNCH(4);
  if (smem_bytes(2, win, hop) <= cap) return MSV_LAUNCH(2);
  if (smem_bytes(1, win, hop) <= cap) return MSV_LAUNCH(1);
#undef MSV_LAUNCH
  return static_cast<int>(cudaErrorInvalidConfiguration);
}

}  // namespace

extern "C" {

// The arguments of msv_mel_spectrogram, with c, s and fb in bf16:
// wave: (batch, wave_stride) f32 or int16 (wave_is_i16), wave_len valid
// samples per row; c, s: (win, n_freq) bf16; fb: (n_freq, n_mel) bf16;
// bands: (n_mel, 2) int32 [lo, hi) bin support of each fb column; out:
// (batch, n_frames, n_mel) f32.  Launches on `stream` without
// synchronising; returns the launch's cudaError_t.
int msv_mel_spectrogram_bf16(const void* wave, int wave_is_i16,
                             long long wave_stride, long long wave_len,
                             int batch, const void* c, const void* s,
                             const void* fb, const int* bands, float* out,
                             int win, int hop, int n_frames, int n_freq,
                             int n_mel, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* cb = static_cast<const __nv_bfloat16*>(c);
  const auto* sb = static_cast<const __nv_bfloat16*>(s);
  const auto* fbb = static_cast<const __nv_bfloat16*>(fb);
  if (wave_is_i16) {
    return launch<int16_t>(wave, wave_stride, wave_len, batch, cb, sb, fbb,
                           bands, out, win, hop, n_frames, n_freq, n_mel, st);
  }
  return launch<float>(wave, wave_stride, wave_len, batch, cb, sb, fbb, bands,
                       out, win, hop, n_frames, n_freq, n_mel, st);
}

}  // extern "C"
