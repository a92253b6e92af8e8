// Fused mel dB spectrogram for Hopper (sm_90a), split-f32 mode.
//
// Replaces the split mode of the TPU kernel msv_tpu/kernels/
// spectrogram_pallas.py::mel_spectrogram_pallas (`_kernel`, :117-140: 4-D
// hi/lo operands from prepare_matrices_split, always the stream schedule).
// Each f32 product is three bf16 tensor-core products with f32
// accumulation, the lo*lo term dropped.  One launch computes, for every
// frame k of every batch row,
//
//   x = padded[k*hop : k*hop + win]          (int16 scaled by 2^-15 first)
//   xh = bf16(x), xl = bf16(x - xh)          (C = Ch + Cl, S = Sh + Sl:
//   re = xh.Ch + xh.Cl + xl.Ch                the (2, win, n_freq) bf16
//   im = xh.Sh + xh.Sl + xl.Sh                stacks of operands_split)
//   mag = sqrt(re^2 + im^2) in f32, mh = bf16(mag), ml = bf16(mag - mh)
//   mel = mh.fbh + mh.fbl + ml.fbh           (fb: (2, n_freq, n_mel) bf16)
//   dB  = 20*ln(mel)/ln(10) if mel > 1e-18 else -360
//
// Rounding is to nearest even.  A product of two bf16 values is exact in
// f32, so this is the plain version's function (kernels/spectrogram_cuda.py
// ::mel_spectrogram_plain, mode="split") up to f32 summation order, and a
// 16-bit sample splits exactly: the int16 route is bit-equal to the f32
// route.
//
// What bounds it on an H100: the DFT pair is 2*2*win*n_freq FLOPs a frame,
// issued three times (189 GFLOP x 3 at 48 kHz for 240 s, 0.57 ms of bf16
// tensor-core time at the 989 TFLOP/s dense peak); HBM traffic (the wave
// once, the dB plane once, about 0.1 GB) is 0.03 ms.  So it is compute-bound
// on paper; in this design, as in the bf16 kernel it grows from, what
// bounds it is staging C/S from L2 (twice the bf16 kernel's bytes: hi and
// lo) between barriers, and shared-memory traffic for the A fragments.
//
// What the design does about it (simple and right first; wgmma, TMA and a
// pipelined producer/consumer design are later work):
//  * The bf16 kernel's tiling: one block per (tile of TF = 16*MT frames,
//    batch row), 8 warps, each warp all TF frames and 32 of the NB = 256
//    frequency columns of the current tile; mma.sync.m16n8k16 with f32
//    accumulation, 3 per fragment pair: 24*MT independent mma per 16
//    samples of K.
//  * Samples are staged once as f32 (4 bytes a sample, as many as a hi and
//    a lo bf16 copy), and each A fragment is split into its hi and lo
//    registers as it is loaded: any frame start, odd hops included, is a
//    plain 4-byte load, so no shifted copy is needed.
//  * Ch, Cl, Sh, Sl are staged per 32-row K slab into shared memory at the
//    bf16 kernel's padded row stride (264 bf16) and read with
//    ldmatrix.x4.trans; rows >= win and columns >= n_freq stage as zeros,
//    only the active warps' columns are staged, and each row's 32 loads are
//    issued before its stores.
//  * The f32 magnitude of a tile overwrites the slabs once the tile's last
//    mma are done (one more barrier), so hi/lo costs no extra shared memory
//    for it; the mel product is mel_common.cuh's sparse band loop in its
//    split form (three products per bin, bins in increasing order, one
//    owner thread per (frame, band): deterministic), then its dB epilogue.
//  * MT (4, 2, then 1) is the largest whose shared memory fits the card.

#include "mel_common.cuh"

namespace {

using msv::WARPS;
using msv::ldmatrix_x4_trans;
using msv::mma_bf16;
constexpr int WCOLS = 32;           // frequency columns per warp
constexpr int NB = WARPS * WCOLS;   // frequency columns per tile
constexpr int KS = 32;              // C/S rows per shared-memory slab
constexpr int NBP = NB + 8;         // padded slab row stride (bf16)
constexpr int SLAB = KS * NBP;      // bf16 elements per slab

// (bf16(x0), bf16(x1)) and their lo parts as two packed A registers.
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(
      x0 - __low2float(h), x1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// MT m-tiles of 16 frames per block; every warp covers all of them.
template <typename T, int MT>
__global__ void __launch_bounds__(32 * WARPS)
mel_db_split_kernel(const T* __restrict__ wave, long long wave_stride,
                    long long wave_len, const __nv_bfloat16* __restrict__ c,
                    const __nv_bfloat16* __restrict__ s,
                    const __nv_bfloat16* __restrict__ fb,
                    const int* __restrict__ bands, float* __restrict__ out,
                    int win, int hop, int n_frames, int n_freq, int n_mel,
                    int chunk_len) {
  constexpr int TF = 16 * MT;
  extern __shared__ float4 smem4[];
  // slabs Ch, Cl, Sh, Sl; the tile's f32 magnitude [NB][TF] reuses them
  __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(smem4);
  float* mag = reinterpret_cast<float*>(smem4);
  float* chunk = reinterpret_cast<float*>(cs + 4 * SLAB);  // f32 samples
  const long long plane = static_cast<long long>(win) * n_freq;

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * 32 + lane;
  const int g = lane >> 2;   // mma group: fragment row / B column
  const int tig = lane & 3;  // thread in group: fragment column pair
  const int f0 = blockIdx.x * TF;
  const T* w = wave + static_cast<long long>(blockIdx.y) * wave_stride;
  const long long base = static_cast<long long>(f0) * hop;

  for (int i = tid; i < chunk_len; i += 32 * WARPS) {
    const long long gi = base + i;
    chunk[i] = gi < wave_len ? msv::load_sample(w, gi) : 0.0f;
  }
  // this thread's A fragment rows: frames mt*16 + g and mt*16 + g + 8
  const float* arow[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) arow[mt][h] = chunk + (mt * 16 + g + 8 * h) * hop;
  }

  float* o = out + (static_cast<long long>(blockIdx.y) * n_frames + f0) * n_mel;
  const int nf = min(TF, n_frames - f0);
  const int wn0 = warp * WCOLS;  // this warp's first column in the tile

  for (int k0 = 0; k0 < n_freq; k0 += NB) {
    const bool active = k0 + wn0 < n_freq;  // warp-uniform
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
#pragma unroll
      for (int rr = 0; rr < KS / WARPS; ++rr) {
        const int r = warp + rr * WARPS;
        const int n = n0 + r;
        __nv_bfloat16 v[4][NB / 32];  // Ch, Cl, Sh, Sl
#pragma unroll
        for (int j = 0; j < NB / 32; ++j) {
          const int col = lane + 32 * j;
          const int k = k0 + col;
          const bool ok = col < ncols && n < win && k < n_freq;
          const long long gi = static_cast<long long>(n) * n_freq + k;
          const __nv_bfloat16 z = __float2bfloat16_rn(0.0f);
          v[0][j] = ok ? c[gi] : z;
          v[1][j] = ok ? c[plane + gi] : z;
          v[2][j] = ok ? s[gi] : z;
          v[3][j] = ok ? s[plane + gi] : z;
        }
#pragma unroll
        for (int j = 0; j < NB / 32; ++j) {
          const int col = lane + 32 * j;
          if (col < ncols) {
#pragma unroll
            for (int q = 0; q < 4; ++q) cs[q * SLAB + r * NBP + col] = v[q][j];
          }
        }
      }
      __syncthreads();
      if (active) {
#pragma unroll
        for (int kk = 0; kk < KS; kk += 16) {
          // B fragments of the warp's 4 n-tiles: [matrix][pair], matrices
          // Ch, Cl, Sh, Sl
          uint32_t b[4][2][4];
          const int brow = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
#pragma unroll
            for (int pr = 0; pr < 2; ++pr) {
              const int bcol = wn0 + pr * 16 + (lane >> 4) * 8;
              ldmatrix_x4_trans(b[q][pr], cs + q * SLAB + brow * NBP + bcol);
            }
          }
          const int ka = n0 + kk + tig * 2;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            uint32_t ah[4], al[4];
            const float* r0 = arow[mt][0] + ka;
            const float* r1 = arow[mt][1] + ka;
            split_pair(r0[0], r0[1], ah[0], al[0]);
            split_pair(r1[0], r1[1], ah[1], al[1]);
            split_pair(r0[8], r0[9], ah[2], al[2]);
            split_pair(r1[8], r1[9], ah[3], al[3]);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              const int pr = nt >> 1, hi = (nt & 1) * 2;
              mma_bf16(re[mt][nt], ah, b[0][pr][hi], b[0][pr][hi + 1]);
              mma_bf16(re[mt][nt], ah, b[1][pr][hi], b[1][pr][hi + 1]);
              mma_bf16(re[mt][nt], al, b[0][pr][hi], b[0][pr][hi + 1]);
              mma_bf16(im[mt][nt], ah, b[2][pr][hi], b[2][pr][hi + 1]);
              mma_bf16(im[mt][nt], ah, b[3][pr][hi], b[3][pr][hi + 1]);
              mma_bf16(im[mt][nt], al, b[2][pr][hi], b[2][pr][hi + 1]);
            }
          }
        }
      }
    }

    __syncthreads();  // every warp's last ldmatrix is done: mag may reuse
    // |X| in f32 into mag[col][frame]
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
            mag[col * TF + f] = sqrtf(x * x + y * y);
          }
        }
      }
    }
    __syncthreads();

    msv::accumulate_bands<TF, true>(mag, fb, bands, o, k0, NB, n_freq, n_mel,
                                    nf, lane, warp);
  }
  msv::db_epilogue<TF>(o, bands, n_mel, nf, lane, warp);
}

// Staged samples: frame TF-1's window rounded up to whole slabs (the A
// fragments read up to sample win_p - 1 of a frame), rounded to 4 floats.
int chunk_elems(int mt, int win, int hop) {
  const int win_p = (win + KS - 1) / KS * KS;
  const long long n = static_cast<long long>(16 * mt - 1) * hop + win_p;
  return static_cast<int>((n + 3) / 4 * 4);
}

size_t smem_bytes(int mt, int win, int hop) {
  // the magnitude [NB][16 * mt] f32 lives in the slabs' space
  static_assert(sizeof(float) * NB * 16 * 4 <= 4 * SLAB * sizeof(__nv_bfloat16),
                "the magnitude must fit the slabs");
  return 4 * sizeof(__nv_bfloat16) * SLAB +
         sizeof(float) * static_cast<size_t>(chunk_elems(mt, win, hop));
}

template <typename T, int MT>
int launch_mt(const void* wave, long long wave_stride, long long wave_len,
              int batch, const __nv_bfloat16* c, const __nv_bfloat16* s,
              const __nv_bfloat16* fb, const int* bands, float* out, int win,
              int hop, int n_frames, int n_freq, int n_mel,
              cudaStream_t stream) {
  const size_t smem = smem_bytes(MT, win, hop);
  cudaError_t err = cudaFuncSetAttribute(
      mel_db_split_kernel<T, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tf = 16 * MT;
  const dim3 grid((n_frames + tf - 1) / tf, batch);
  const dim3 block(32, WARPS);
  mel_db_split_kernel<T, MT><<<grid, block, smem, stream>>>(
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

// The arguments of msv_mel_spectrogram, with c, s and fb the split stacks:
// c, s: (2, win, n_freq) bf16 (hi, lo); fb: (2, n_freq, n_mel) bf16;
// bands: (n_mel, 2) int32 [lo, hi) bin support of fb's hi or lo plane;
// out: (batch, n_frames, n_mel) f32.  Launches on `stream` without
// synchronising; returns the launch's cudaError_t.
int msv_mel_spectrogram_split(const void* wave, int wave_is_i16,
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
