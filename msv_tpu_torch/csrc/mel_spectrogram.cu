// Fused mel dB spectrogram for Hopper (sm_90a).
//
// Replaces the TPU kernel msv_tpu/kernels/spectrogram_pallas.py::
// mel_spectrogram_pallas (both schedules, `resident` and `stream`, in f32
// operand mode).  One launch computes, for every frame k of every batch row,
//
//   frame = padded[k*hop : k*hop + win]        (int16 input scaled by 2^-15)
//   re = frame . C,  im = frame . S            (C, S: (win, n_freq) f32)
//   mel = sqrt(re^2 + im^2) . fb               (fb: (n_freq, n_mel) f32)
//   dB  = 20*ln(mel)/ln(10) if mel > 1e-18 else -360
//
// What bounds it on an H100: arithmetic.  The DFT pair costs
// 2*win*n_freq*2 FLOPs a frame (7.9 MFLOP at 48 kHz: win 1920, n_freq 1025)
// against win*4 bytes of new samples, far above the memory roofline.  The
// math is f32 FMA on the SIMT cores, so the result is true f32 (no TF32 or
// bf16 rounding): this is the parity mode.  The SIMT rate, not the tensor
// cores, is the ceiling here.
//
// What the design does about it:
//  * One block per (tile of TF = 32*FPT frames, batch row), 8 warps.  Lane l
//    of every warp owns frames l, l+32, ... (FPT of them) of the tile; warp w
//    owns CPT = 8 of the KT = 64 DFT columns of the current frequency tile.
//    Per sample n a thread does 16*FPT FMAs for FPT conflict-free loads of
//    its samples and 4 broadcast 16-byte loads of C/S: more frames per lane
//    means fewer C/S loads per FMA (on an H100 at 700 W and 48 kHz, 3 frames
//    per lane ran 1.2x faster than 2; 2 ran 2x faster than 1 with the mel
//    sums still in shared memory).  FPT is the largest of 3, 2, 1 whose tile
//    fits the card's shared memory (3 for every default rate).
//  * The block stages its raw samples once, as rows of `hop` samples at an
//    odd row stride (hop | 1): frame f's sample n sits in row f + n/hop, so
//    the 32 lanes read 32 different banks.  Device memory sees the wave once,
//    not win/hop = 4 times as frames.  Loads are scalar: hops of 221 and 441
//    leave rows that are not 16-byte aligned.
//  * C/S are streamed through shared memory in NK = 32-row slices, the next
//    slice held in registers while the current one is used.
//  * The mel GEMM reads only each band's nonzero support (a Slaney band
//    covers a contiguous run of bins, `bands` gives [lo, hi) per band), so
//    it costs about 2*n_freq FMAs a frame instead of n_freq*n_mel.  Adding
//    the skipped zero products would not change the sums.  The mel sums
//    accumulate in the output buffer, which is rewritten as dB at the end.
//  * Each (frame, band) sum has one owner thread, adding bins in increasing
//    order: no atomics, deterministic, and the int16 route is bit-equal to
//    the f32 route.  Ragged edges are masked in the kernel.  The band loop
//    and the dB epilogue are mel_common.cuh's, shared with the bf16 kernel.
// Tensor cores (a split-bf16 or TF32 mode), TMA and wgmma are later work.

#include "mel_common.cuh"

namespace {

using msv::WARPS;
constexpr int CPT = 8;         // DFT columns per warp
constexpr int KT = WARPS * CPT;  // frequency columns per tile
constexpr int NK = 32;         // C/S rows per shared-memory slice
constexpr int SLICE = NK * KT;   // floats per C (or S) slice
constexpr int PER_THREAD = SLICE / (32 * WARPS);

struct SliceRegs {
  float c[PER_THREAD];
  float s[PER_THREAD];
};

// Rows n0..n0+NK of C and S, columns k0..k0+KT, zero outside the matrices.
__device__ __forceinline__ void load_slice(SliceRegs& r, const float* c,
                                           const float* s, int n0, int k0,
                                           int win, int n_freq, int tid) {
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    const int idx = tid + q * 32 * WARPS;
    const int n = n0 + idx / KT;
    const int k = k0 + idx % KT;
    const bool ok = n < win && k < n_freq;
    const long long g = static_cast<long long>(n) * n_freq + k;
    r.c[q] = ok ? __ldg(c + g) : 0.0f;
    r.s[q] = ok ? __ldg(s + g) : 0.0f;
  }
}

__device__ __forceinline__ void store_slice(const SliceRegs& r, float* cs,
                                            int tid) {
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    cs[tid + q * 32 * WARPS] = r.c[q];
    cs[SLICE + tid + q * 32 * WARPS] = r.s[q];
  }
}

// FPT frames per lane: a block covers TF = 32 * FPT frames.
template <typename T, int FPT>
__global__ void __launch_bounds__(32 * WARPS)
mel_db_kernel(const T* __restrict__ wave, long long wave_stride,
              long long wave_len, const float* __restrict__ c,
              const float* __restrict__ s, const float* __restrict__ fb,
              const int* __restrict__ bands, float* __restrict__ out,
              int win, int hop, int n_frames, int n_freq, int n_mel) {
  constexpr int TF = 32 * FPT;
  extern __shared__ float4 smem4[];
  float* cs = reinterpret_cast<float*>(smem4);  // C slice, then S slice
  float* mag = cs + 2 * SLICE;                  // [KT][TF]
  float* chunk = mag + KT * TF;                 // [rows][hs]
  const int hs = hop | 1;
  const int rows = TF - 1 + (win + hop - 1) / hop;

  const int lane = threadIdx.x;  // frames lane, lane + 32, ... of the tile
  const int warp = threadIdx.y;
  const int tid = warp * 32 + lane;
  const int f0 = blockIdx.x * TF;
  const T* w = wave + static_cast<long long>(blockIdx.y) * wave_stride;
  const long long base = static_cast<long long>(f0) * hop;

  for (int i = tid; i < rows * hop; i += 32 * WARPS) {
    const long long g = base + i;
    chunk[(i / hop) * hs + i % hop] =
        g < wave_len ? msv::load_sample(w, g) : 0.0f;
  }
  // The mel sums accumulate in `out` itself: entry (f, m) belongs to the
  // thread of lane f % 32 in warp m % WARPS, across every tile.
  float* o = out + (static_cast<long long>(blockIdx.y) * n_frames + f0) * n_mel;
  const int nf = min(TF, n_frames - f0);

  for (int k0 = 0; k0 < n_freq; k0 += KT) {
    float re[FPT][CPT], im[FPT][CPT];
#pragma unroll
    for (int h = 0; h < FPT; ++h) {
#pragma unroll
      for (int q = 0; q < CPT; ++q) re[h][q] = im[h][q] = 0.0f;
    }
    SliceRegs regs;
    load_slice(regs, c, s, 0, k0, win, n_freq, tid);
    store_slice(regs, cs, tid);
    __syncthreads();

    const float* p = chunk + lane * hs;  // frame `lane`, sample 0; frame
                                         // lane + 32h is 32h rows further
    int j = 0;                           // n % hop
    for (int n0 = 0; n0 < win; n0 += NK) {
      const bool more = n0 + NK < win;
      if (more) load_slice(regs, c, s, n0 + NK, k0, win, n_freq, tid);
      const int nk = min(NK, win - n0);
      const float* crow = cs + warp * CPT;
#pragma unroll 4
      for (int nn = 0; nn < nk; ++nn) {
        const float4 c0 = *reinterpret_cast<const float4*>(crow + nn * KT);
        const float4 c1 = *reinterpret_cast<const float4*>(crow + nn * KT + 4);
        const float4 s0 =
            *reinterpret_cast<const float4*>(crow + SLICE + nn * KT);
        const float4 s1 =
            *reinterpret_cast<const float4*>(crow + SLICE + nn * KT + 4);
        const float cv[CPT] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
        const float sv[CPT] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
        for (int h = 0; h < FPT; ++h) {
          const float x = p[h * 32 * hs];
#pragma unroll
          for (int q = 0; q < CPT; ++q) {
            re[h][q] = fmaf(x, cv[q], re[h][q]);
            im[h][q] = fmaf(x, sv[q], im[h][q]);
          }
        }
        ++p;
        if (++j == hop) {  // next row of the odd-stride layout
          j = 0;
          p += hs - hop;
        }
      }
      __syncthreads();
      if (more) {
        store_slice(regs, cs, tid);
        __syncthreads();
      }
    }

#pragma unroll
    for (int h = 0; h < FPT; ++h) {
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        mag[(warp * CPT + q) * TF + h * 32 + lane] =
            sqrtf(re[h][q] * re[h][q] + im[h][q] * im[h][q]);
      }
    }
    __syncthreads();

    msv::accumulate_bands<TF>(mag, fb, bands, o, k0, KT, n_freq, n_mel, nf,
                              lane, warp);
  }
  msv::db_epilogue<TF>(o, bands, n_mel, nf, lane, warp);
}

size_t smem_bytes(int fpt, int win, int hop) {
  const int rows = 32 * fpt - 1 + (win + hop - 1) / hop;
  return sizeof(float) * (2 * static_cast<size_t>(SLICE) +
                          static_cast<size_t>(KT) * 32 * fpt +
                          static_cast<size_t>(rows) * (hop | 1));
}

template <typename T, int FPT>
int launch_fpt(const void* wave, long long wave_stride, long long wave_len,
               int batch, const float* c, const float* s, const float* fb,
               const int* bands, float* out, int win, int hop, int n_frames,
               int n_freq, int n_mel, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mel_db_kernel<T, FPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tf = 32 * FPT;
  const dim3 grid((n_frames + tf - 1) / tf, batch);
  const dim3 block(32, WARPS);
  mel_db_kernel<T, FPT><<<grid, block, smem, stream>>>(
      static_cast<const T*>(wave), wave_stride, wave_len, c, s, fb, bands,
      out, win, hop, n_frames, n_freq, n_mel);
  return static_cast<int>(cudaGetLastError());
}

// The most frames per lane (3, 2, then 1) whose staged samples fit the
// card's shared memory: more frames per lane means fewer C/S loads per FMA.
template <typename T>
int launch(const void* wave, long long wave_stride, long long wave_len,
           int batch, const float* c, const float* s, const float* fb,
           const int* bands, float* out, int win, int hop, int n_frames,
           int n_freq, int n_mel, cudaStream_t stream) {
  size_t cap = 0;
  if (const int err = msv::smem_optin_limit(&cap)) return err;
#define MSV_LAUNCH(F)                                                      \
  launch_fpt<T, F>(wave, wave_stride, wave_len, batch, c, s, fb, bands,   \
                   out, win, hop, n_frames, n_freq, n_mel,                \
                   smem_bytes(F, win, hop), stream)
  if (smem_bytes(3, win, hop) <= cap) return MSV_LAUNCH(3);
  if (smem_bytes(2, win, hop) <= cap) return MSV_LAUNCH(2);
  if (smem_bytes(1, win, hop) <= cap) return MSV_LAUNCH(1);
#undef MSV_LAUNCH
  return static_cast<int>(cudaErrorInvalidConfiguration);
}

}  // namespace

extern "C" {

// wave: (batch, wave_stride) f32 or int16 (wave_is_i16), wave_len valid
// samples per row; bands: (n_mel, 2) int32 [lo, hi) bin support of each fb
// column; out: (batch, n_frames, n_mel) f32.  Launches on `stream` without
// synchronising; returns the launch's cudaError_t.
int msv_mel_spectrogram(const void* wave, int wave_is_i16,
                        long long wave_stride, long long wave_len, int batch,
                        const float* c, const float* s, const float* fb,
                        const int* bands, float* out, int win, int hop,
                        int n_frames, int n_freq, int n_mel, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wave_is_i16) {
    return launch<int16_t>(wave, wave_stride, wave_len, batch, c, s, fb,
                           bands, out, win, hop, n_frames, n_freq, n_mel, st);
  }
  return launch<float>(wave, wave_stride, wave_len, batch, c, s, fb, bands,
                       out, win, hop, n_frames, n_freq, n_mel, st);
}

const char* msv_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
