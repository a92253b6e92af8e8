// Fused mel dB spectrogram for Hopper (sm_90a), f32 parity mode: the FFT
// tier, for windows whose samples no resident block of mel_spectrogram.cu
// holds (from 176.4 kHz on at the session's settings: windows of 7056 to
// 15 360 samples, n_fft 8192 and 16 384).  One launch computes, for every
// frame k of every batch row, the function of mel_spectrogram.cu,
//
//   x   = window * padded[k*hop : k*hop + win], zero-padded to n_fft at
//         the left offset (n_fft - win) / 2   (int16 input scaled by 2^-15)
//   mel = |rfft_n_fft(x)| . fb                (fb: (n_fft/2 + 1, n_mel) f32)
//   dB  = 20*ln(mel)/ln(10) if mel > 1e-18 else -360
//
// by a real FFT of n_fft points in f32 instead of the product of the frame
// with the (win, n_fft/2 + 1) windowed DFT matrices C and S.  Its linear-scale
// form (linear_db_fft_kernel, msv_linear_spectrogram_fft) runs the same
// load, passes and split (frame_magnitudes) and writes the dB of every bin,
//
//   dB[k] = 20*ln(|X[k]|)/ln(10) if |X[k]| > 1e-18 else -360,  k <= n_fft/2,
//
// in place of the linear route's dense GEMM pair (kernels/pipeline.py::
// spec_pipeline_batched, 15 360 x 8193 C and S at 384 kHz).
//
// What it replaces: the parity kernel's chunked tier
// (mel_spectrogram.cu::mel_db_tf32_chunked_kernel), which took these windows
// as a dense DFT pair, about 880 times an FFT's operations at n_fft 16 384,
// and read 2 GB of C/S slabs a session.  The TPU kernel has no such tier
// (msv_tpu/kernels/spectrogram_pallas.py::mel_spectrogram_pallas holds
// whole windows in VMEM and runs the dense pair on the MXU).
//
// What bounds it on an H100: shared memory.  A 16 384-point real FFT is a
// complex FFT of M = 8192 points, 64 KB of f32 a frame; its operations
// (2.5 * n_fft * log2 n_fft a frame, 17.2 GFLOP for a 300 s track at 384
// kHz, 0.26 ms at the 67 TFLOP/s of f32 SIMT) and its device-memory bytes
// (the wave, the dB plane) are small beside the exchanges between radix
// passes: each pass reads and writes the frame's 64 KB in shared memory,
// about 128 B a clock an SM, and with the spectrum's split, the magnitudes
// and the mel pass about 0.5 MB a frame, near 0.5 ms a 384 kHz track.
// The window, the twiddles and the mel weights (about 0.2 MB a frame at
// 384 kHz, the same for every frame) come through L1 and L2.  Measured
// (kernels/probe.py --fft, NVIDIA H100 80GB HBM3 at 700 W, 300 s at 384
// kHz, B = 1): 3.06 ms, of which the FFT and the magnitudes 1.77 ms; the
// mel pass waits on the weights' loads from L2.
//
// What the design does about it:
//  * One block per frame and batch row; the frame's M complex points live
//    in shared memory, padded by one point after every 16 (pad()), so that
//    every exchange below is free of bank conflicts.
//  * x is packed as z[n] = x[2n] + i x[2n+1], M = n_fft / 2 points, and
//    transformed by a Stockham FFT (self-sorting: natural order in and out,
//    no bit-reversal pass) of three radix passes (FftPlan: 16 x 16 x 8 to
//    16 x 32 x 32).  Each pass holds a thread's M / T points in registers:
//    its butterflies load their points, the block waits, each butterfly is
//    multiplied by its twiddles and transformed in registers (a radix-2
//    network unrolled at compile time over the constants cos32 / sin32),
//    and the points are stored to their place for the next pass, in
//    place.
//  * The first pass reads the frame straight from device memory, windowed
//    as it is loaded (the product rounded once, as x's): a warp reads 64
//    consecutive samples of each point group, a pair a lane in one 8-byte
//    (f32) or 4-byte (int16) load where the frame's pairs are aligned, and
//    its window values in one 8-byte load; the points of the zero pad are
//    not loaded.  int16 samples are scaled by 2^-15 (exact), so the int16
//    route is bit-equal to the f32 route.
//  * Twiddles come from one table per launch shape (kernels/
//    spectrogram_cuda.py::fft_twiddles): computed in float64 and rounded
//    once to f32, no recurrence and no __sinf; laid out per pass as
//    [r - 1][k], so a warp's twiddle loads are 256 contiguous bytes.
//  * The split to the n_fft/2 + 1 real-FFT bins pairs bins k and M - k
//    (X[k] = E + W^k O, |X[M - k]| = |E - W^k O|), the magnitudes go over
//    the points, and mel_common.cuh's mel_frame runs the band-sparse mel
//    pass and the dB: a warp a few bands at a time, lanes along the bins,
//    so its loads of the weights are coalesced and several in flight.  The
//    linear form stores each thread's bins k and M - k as dB straight from
//    registers: a warp's 32 consecutive bins, coalesced, and no barrier or
//    shared memory after the split (a 384 kHz track's plane is 0.98 GB, so
//    there the stores, about 0.3 ms at the HBM rate, join the passes).
//  * Registers against blocks: M = 8192 takes 256 threads of 32 points at
//    three blocks an SM, as many as its 70 KB of shared memory allow: 80
//    registers a thread, about 150 bytes of them spilled to L1, and the
//    block that waits on its mel pass's loads overlaps the others' passes
//    (on an H100 80GB HBM3 at 700 W, 300 s at 384 kHz: 3.05 ms against
//    3.93 ms at two blocks an SM and 128 registers, kernels/probe.py
//    --fft); M = 4096 takes 256 threads of 16 points (80 registers, three
//    blocks an SM or more).

#include <type_traits>

#include "mel_common.cuh"

namespace {

// Radix passes and threads by M = n_fft / 2 complex points: T threads of
// M / T points, passes R0, R1, R2 (each dividing M / T), MINB blocks an SM
// for __launch_bounds__.  kernels/spectrogram_cuda.py::FFT_PLANS mirrors
// the radices (the twiddle table's layout follows them).
template <int M>
struct FftPlan;
template <>
struct FftPlan<2048> {
  static constexpr int T = 128, R0 = 16, R1 = 16, R2 = 8, MINB = 6;
};
template <>
struct FftPlan<4096> {
  static constexpr int T = 256, R0 = 16, R1 = 16, R2 = 16, MINB = 3;
};
template <>
struct FftPlan<8192> {
  static constexpr int T = 256, R0 = 16, R1 = 16, R2 = 32, MINB = 3;
};
template <>
struct FftPlan<16384> {
  static constexpr int T = 512, R0 = 16, R1 = 32, R2 = 32, MINB = 1;
};

// The twiddle table of a plan (float2 entries): W_N^k for k in [0, M/2]
// (N = 2M, the split), then pass 1's and pass 2's: entry (r - 1) * NS + k
// is W_{NS R}^{r k} for r in [1, R), k < NS, NS the product of the radices
// before the pass.
template <int M>
struct FftTable {
  using P = FftPlan<M>;
  static constexpr int SPLIT = M / 2 + 1;
  static constexpr int PASS1 = SPLIT;
  static constexpr int PASS2 = PASS1 + (P::R1 - 1) * P::R0;
  static constexpr int SIZE = PASS2 + (P::R2 - 1) * P::R0 * P::R1;
};

// Bands a warp of the mel pass sums at a time (their loads in flight
// together).
constexpr int kBandsAtOnce = 4;

// Point i of the frame in shared memory: one point of padding after every
// 16, so that 16 threads storing points 16 apart (the first pass), or 16
// consecutive points, meet 32 distinct banks.
__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

template <int M>
__host__ __device__ constexpr int buffer_points() {
  return M + M / 16;
}

// cos and sin of 2 pi t / 32, t < 16: float64 values rounded once to f32.
__host__ __device__ constexpr float cos32(int t) {
  switch (t) {
    case 0: return 1.0f;
    case 1: return 0.98078525f;
    case 2: return 0.9238795f;
    case 3: return 0.8314696f;
    case 4: return 0.70710677f;
    case 5: return 0.55557024f;
    case 6: return 0.38268343f;
    case 7: return 0.19509032f;
    case 8: return 0.0f;
    default: return -cos32(16 - t);
  }
}

__host__ __device__ constexpr float sin32(int t) {
  return t <= 8 ? cos32(8 - t) : cos32(t - 8);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// a * w
__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(fmaf(a.x, w.x, -a.y * w.y), fmaf(a.x, w.y, a.y * w.x));
}

// d * W_32^T, W_32 = exp(-2 pi i / 32): 1 and -i exactly.
template <int T>
__device__ __forceinline__ float2 times_w32(float2 d) {
  if constexpr (T == 0) {
    return d;
  } else if constexpr (T == 8) {
    return make_float2(d.y, -d.x);
  } else {
    constexpr float c = cos32(T), s = sin32(T);
    return cmul(d, make_float2(c, -s));
  }
}

template <int R>
__host__ __device__ constexpr int bitrev(int i) {
  int r = 0;
  for (int b = 1; b < R; b <<= 1, i >>= 1) r = (r << 1) | (i & 1);
  return r;
}

// The DFT of R points in registers, in place, natural order in and out:
// radix-2 decimation in frequency, then the bit-reversal as register
// renaming.  Every index and twiddle is a template constant (the stages,
// pairs and swaps unrolled by recursion), so the points never leave
// registers.  Stage LEN's pair K, (I + J, I + J + LEN / 2), multiplies the
// difference by W_LEN^J = W_32^(J * 32 / LEN).
template <int R, int LEN, int K>
__device__ __forceinline__ void dif_pairs(float2 (&v)[R]) {
  if constexpr (K < R / 2) {
    constexpr int H = LEN / 2, I = K / H * LEN, J = K % H;
    const float2 a = v[I + J], b = v[I + J + H];
    v[I + J] = cadd(a, b);
    v[I + J + H] = times_w32<J * (32 / LEN)>(csub(a, b));
    dif_pairs<R, LEN, K + 1>(v);
  }
}

template <int R, int I>
__device__ __forceinline__ void bit_reverse(float2 (&v)[R]) {
  if constexpr (I < R) {
    constexpr int J = bitrev<R>(I);
    if constexpr (J > I) {
      const float2 t = v[I];
      v[I] = v[J];
      v[J] = t;
    }
    bit_reverse<R, I + 1>(v);
  }
}

template <int R, int LEN = R>
__device__ __forceinline__ void dft(float2 (&v)[R]) {
  static_assert(R >= 2 && R <= 32 && (R & (R - 1)) == 0, "R: 2 to 32");
  if constexpr (LEN >= 2) {
    dif_pairs<R, LEN, 0>(v);
    dft<R, LEN / 2>(v);
  } else {
    bit_reverse<R, 0>(v);
  }
}

// The butterflies of one Stockham pass whose points a thread holds: butterfly
// j = tid + b * T, k = j mod NS; its R points (read from j + r * M / R) times
// W_{NS R}^{r k}, transformed, and stored at (j - k) * R + k + r * NS.
template <int M, int T, int R, int NS>
__device__ __forceinline__ void butterflies(float2 (&v)[M / (R * T)][R],
                                            float2* buf,
                                            const float2* __restrict__ tw,
                                            int tid) {
  constexpr int NB = M / (R * T);
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const int j = tid + b * T;
    const int k = j & (NS - 1);
    if constexpr (NS > 1) {
#pragma unroll
      for (int r = 1; r < R; ++r)
        v[b][r] = cmul(v[b][r], __ldg(tw + (r - 1) * NS + k));
    }
    dft<R>(v[b]);
    const int base = (j - k) * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) buf[pad(base + r * NS)] = v[b][r];
  }
}

// A pass after the first: every thread reads its points, the block waits,
// then each thread transforms and stores them (in place), and the block
// waits again.
template <int M, int T, int R, int NS>
__device__ __forceinline__ void fft_pass(float2* buf,
                                         const float2* __restrict__ tw,
                                         int tid) {
  constexpr int NB = M / (R * T);
  static_assert(NB >= 1 && NB * R * T == M, "a pass covers M points");
  float2 v[NB][R];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int r = 0; r < R; ++r) v[b][r] = buf[pad(tid + b * T + r * (M / R))];
  __syncthreads();
  butterflies<M, T, R, NS>(v, buf, tw, tid);
  __syncthreads();
}

// Point n of the packed frame, z[n] = x[2n] + i x[2n+1]: samples s and s + 1
// of the window (s = 2n - left; zero outside [0, win) and past the wave),
// each times its window value, rounded once.  Where the block's pairs are
// aligned (`paired`) and both samples lie inside, one load of the pair and
// one of its window values.
template <typename T>
__device__ __forceinline__ float2 load_point(const T* __restrict__ w,
                                             long long g0, long long wave_len,
                                             const float* __restrict__ window,
                                             int s, int win, bool paired) {
  if (paired && s >= 0 && s + 1 < win && g0 + s + 1 < wave_len) {
    float2 x;
    if constexpr (sizeof(T) == sizeof(float)) {
      x = *reinterpret_cast<const float2*>(w + g0 + s);
    } else {  // int16, scaled as msv::load_sample scales it
      const short2 v = *reinterpret_cast<const short2*>(w + g0 + s);
      x = make_float2(static_cast<float>(v.x) * 3.0517578125e-05f,
                      static_cast<float>(v.y) * 3.0517578125e-05f);
    }
    const float2 wv = __ldg(reinterpret_cast<const float2*>(window + s));
    return make_float2(__fmul_rn(x.x, wv.x), __fmul_rn(x.y, wv.y));
  }
  float2 p = make_float2(0.0f, 0.0f);
  if (s >= 0 && s < win && g0 + s < wave_len)
    p.x = __fmul_rn(msv::load_sample(w, g0 + s), __ldg(window + s));
  if (s + 1 >= 0 && s + 1 < win && g0 + s + 1 < wave_len)
    p.y = __fmul_rn(msv::load_sample(w, g0 + s + 1), __ldg(window + s + 1));
  return p;
}

// The split's bins a thread holds: k = tid + q * T for k <= M / 2.
template <int M>
__host__ __device__ constexpr int split_bins() {
  return (M / 2 + FftPlan<M>::T) / FftPlan<M>::T;
}

// The magnitudes of one frame's real FFT of N = 2M points, by the block
// that owns it (a block per frame and batch row), in registers: lo[q] =
// |X[k]| and hi[q] = |X[M - k]| for k = tid + q * T <= M / 2 (hi is not set
// at k = M / 2).  The frame's points pass through `buf` in shared memory;
// the block has passed its last barrier on return, so `buf` may still be
// read by other threads until the caller's next __syncthreads().
template <typename T, int M>
__device__ __forceinline__ void frame_magnitudes(
    const T* __restrict__ w, long long g0, long long wave_len,
    const float* __restrict__ window, const float2* __restrict__ tw, int win,
    int left, float2* buf, int tid, float (&lo_mag)[split_bins<M>()],
    float (&hi_mag)[split_bins<M>()]) {
  using P = FftPlan<M>;
  using Tab = FftTable<M>;
  constexpr int TH = P::T;
  // pairs (s, s + 1), s = 2n - left, start at aligned addresses
  const bool paired =
      (left & 1) == 0 &&
      (reinterpret_cast<uintptr_t>(w + g0) & (2 * sizeof(T) - 1)) == 0;

  {  // the first pass, from device memory: NS = 1, no twiddles
    constexpr int R = P::R0, NB = M / (R * TH);
    static_assert(NB >= 1 && NB * R * TH == M, "a pass covers M points");
    float2 v[NB][R];
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int r = 0; r < R; ++r)
        v[b][r] = load_point(w, g0, wave_len, window,
                             2 * (tid + b * TH + r * (M / R)) - left, win,
                             paired);
    butterflies<M, TH, R, 1>(v, buf, nullptr, tid);
    __syncthreads();
  }
  fft_pass<M, TH, P::R1, P::R0>(buf, tw + Tab::PASS1, tid);
  fft_pass<M, TH, P::R2, P::R0 * P::R1>(buf, tw + Tab::PASS2, tid);

  // the split: bins k and M - k from Z[k] and Z[M - k] (Z[M] = Z[0]):
  // E = (Z[k] + conj Z[M-k]) / 2, O = -i (Z[k] - conj Z[M-k]) / 2,
  // X[k] = E + W_N^k O and X[M - k] = conj(E - W_N^k O)
#pragma unroll
  for (int q = 0; q < split_bins<M>(); ++q) {
    const int k = tid + q * TH;
    if (k <= M / 2) {
      const float2 a = buf[pad(k)], b = buf[pad((M - k) & (M - 1))];
      const float2 e = make_float2(0.5f * (a.x + b.x), 0.5f * (a.y - b.y));
      const float2 o = make_float2(0.5f * (a.y + b.y), 0.5f * (b.x - a.x));
      const float2 t = cmul(o, __ldg(tw + k));
      const float2 xp = cadd(e, t), xm = csub(e, t);
      lo_mag[q] = sqrtf(xp.x * xp.x + xp.y * xp.y);
      hi_mag[q] = sqrtf(xm.x * xm.x + xm.y * xm.y);
    }
  }
}

// One block per (frame, batch row): the frame's real FFT of N = 2M points in
// shared memory, its magnitudes, then the mel pass and the dB.
template <typename T, int M>
__global__ void __launch_bounds__(FftPlan<M>::T, FftPlan<M>::MINB)
mel_db_fft_kernel(const T* __restrict__ wave, long long wave_stride,
                  long long wave_len, const float* __restrict__ window,
                  const float2* __restrict__ tw,
                  const int* __restrict__ bands, const int* __restrict__ woff,
                  const float* __restrict__ wts, float* __restrict__ out,
                  int win, int hop, int n_frames, int n_mel, int left) {
  constexpr int TH = FftPlan<M>::T;
  constexpr int NQ = split_bins<M>();
  extern __shared__ __align__(16) unsigned char smem[];
  float2* buf = reinterpret_cast<float2*>(smem);
  const int tid = threadIdx.x;
  const int f = blockIdx.x;
  const T* w = wave + static_cast<long long>(blockIdx.y) * wave_stride;
  float lo_mag[NQ], hi_mag[NQ];
  frame_magnitudes<T, M>(w, static_cast<long long>(f) * hop, wave_len,
                         window, tw, win, left, buf, tid, lo_mag, hi_mag);
  __syncthreads();  // every point is read: the magnitudes go over them
  float* mag = reinterpret_cast<float*>(smem);  // mag[k], k <= M
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int k = tid + q * TH;
    if (k <= M / 2) {
      mag[k] = lo_mag[q];
      if (k != M / 2) mag[M - k] = hi_mag[q];
    }
  }
  __syncthreads();

  float* o = out + (static_cast<long long>(blockIdx.y) * n_frames + f) * n_mel;
  float* sums = mag + M + 4;
  msv::mel_frame<TH / 32, kBandsAtOnce>(
      mag, reinterpret_cast<int*>(sums + n_mel), sums, bands, woff, wts, o,
      n_mel, tid);
}

// The linear scale's epilogue: one block per (frame, batch row), the same
// FFT and magnitudes, and the dB of every bin k in [0, M] written straight
// from registers, row (batch row, frame) of M + 1 floats.  Consecutive
// threads hold consecutive bins k (and M - k), so each warp's stores are
// coalesced; no filterbank, no second barrier.
template <typename T, int M>
__global__ void __launch_bounds__(FftPlan<M>::T, FftPlan<M>::MINB)
linear_db_fft_kernel(const T* __restrict__ wave, long long wave_stride,
                     long long wave_len, const float* __restrict__ window,
                     const float2* __restrict__ tw, float* __restrict__ out,
                     int win, int hop, int n_frames, int left) {
  constexpr int TH = FftPlan<M>::T;
  constexpr int NQ = split_bins<M>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int f = blockIdx.x;
  const T* w = wave + static_cast<long long>(blockIdx.y) * wave_stride;
  float lo_mag[NQ], hi_mag[NQ];
  frame_magnitudes<T, M>(w, static_cast<long long>(f) * hop, wave_len,
                         window, tw, win, left,
                         reinterpret_cast<float2*>(smem), tid, lo_mag,
                         hi_mag);
  float* o =
      out + (static_cast<long long>(blockIdx.y) * n_frames + f) * (M + 1);
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int k = tid + q * TH;
    if (k <= M / 2) {
      o[k] = msv::amp_db(lo_mag[q]);
      if (k != M / 2) o[M - k] = msv::amp_db(hi_mag[q]);
    }
  }
}

// Shared memory of a block: the padded points, or (the mel epilogue, n_mel
// > 0) the magnitudes (M + 1), the band sums and the band tables (4 words a
// band) after them, whichever is more.
template <int M>
size_t block_bytes(int n_mel) {
  const size_t points = sizeof(float2) * buffer_points<M>();
  const size_t mel = n_mel > 0 ? 4 * (static_cast<size_t>(M) + 4 + 4 * n_mel)
                               : 0;
  return points > mel ? points : mel;
}

// Launch `kernel` (a block of FftPlan<M>::T threads per frame and batch row)
// with `smem` bytes of shared memory, or report on `plan` that it does not
// fit the card.
template <int M, typename... Params, typename... Args>
int launch_fft(void (*kernel)(Params...), size_t smem, int n_frames,
               int batch, msv::Plan* plan, cudaStream_t stream,
               Args... args) {
  *plan = {msv::kFft, 1, 0, 0, static_cast<int>(smem), plan->avail};
  if (smem > static_cast<size_t>(plan->avail)) {
    plan->tier = msv::kNoTier;
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(n_frames, batch), FftPlan<M>::T, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// f(std::integral_constant<int, M>) for the plan of n_fft = 2M, after the
// card's shared memory is read into `plan`; cudaErrorInvalidValue, calling
// nothing, for an n_fft without a plan or a table of another size.
template <typename F>
int with_plan(int n_fft, int n_tw, msv::Plan* plan, F&& f) {
  msv::SmemLimits lim;
  if (const int err = msv::smem_limits(&lim)) return err;
  plan->avail = static_cast<int>(lim.block);
  auto run = [&](auto m) {
    return n_tw == FftTable<decltype(m)::value>::SIZE
               ? f(m)
               : static_cast<int>(cudaErrorInvalidValue);
  };
  switch (n_fft / 2) {
    case 2048: return run(std::integral_constant<int, 2048>{});
    case 4096: return run(std::integral_constant<int, 4096>{});
    case 8192: return run(std::integral_constant<int, 8192>{});
    case 16384: return run(std::integral_constant<int, 16384>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_mel(const void* wave, long long wave_stride, long long wave_len,
               int batch, const float* window, const float2* tw,
               const int* bands, const int* woff, const float* wts,
               float* out, int win, int hop, int n_frames, int n_fft,
               int n_mel, int n_tw, msv::Plan* plan, cudaStream_t stream) {
  return with_plan(n_fft, n_tw, plan, [&](auto m) {
    constexpr int M = decltype(m)::value;
    return launch_fft<M>(mel_db_fft_kernel<T, M>, block_bytes<M>(n_mel),
                         n_frames, batch, plan, stream,
                         static_cast<const T*>(wave), wave_stride, wave_len,
                         window, tw, bands, woff, wts, out, win, hop,
                         n_frames, n_mel, (2 * M - win) / 2);
  });
}

template <typename T>
int launch_linear(const void* wave, long long wave_stride,
                  long long wave_len, int batch, const float* window,
                  const float2* tw, float* out, int win, int hop,
                  int n_frames, int n_fft, int n_tw, msv::Plan* plan,
                  cudaStream_t stream) {
  return with_plan(n_fft, n_tw, plan, [&](auto m) {
    constexpr int M = decltype(m)::value;
    return launch_fft<M>(linear_db_fft_kernel<T, M>, block_bytes<M>(0),
                         n_frames, batch, plan, stream,
                         static_cast<const T*>(wave), wave_stride, wave_len,
                         window, tw, out, win, hop, n_frames,
                         (2 * M - win) / 2);
  });
}

}  // namespace

extern "C" {

// wave: (batch, wave_stride) f32 or int16 (wave_is_i16), wave_len valid
// samples per row; window: (win,) f32; twiddles: (n_tw,) float2, the table
// of kernels/spectrogram_cuda.py::fft_twiddles(n_fft); wts, bands, woff: the
// compact filterbank of a prepared record (bands (n_mel, 2) int32 [lo, hi)
// bins, band m's weights from woff[m]); out: (batch, n_frames, n_mel) f32.
// n_fft is 4096, 8192, 16 384 or 32 768 and at least win.  plan: 6 ints,
// the launch's choice (msv::Plan).  Launches on `stream` without
// synchronising; returns the launch's cudaError_t (cudaErrorInvalidValue,
// launching nothing, for an n_fft without a plan or a table of another
// size).
int msv_mel_spectrogram_fft(const void* wave, int wave_is_i16,
                            long long wave_stride, long long wave_len,
                            int batch, const void* window,
                            const void* twiddles, const void* wts,
                            const int* bands, const int* woff, float* out,
                            int win, int hop, int n_frames, int n_fft,
                            int n_mel, int n_tw, void* stream, int* plan) {
  msv::Plan* pl = reinterpret_cast<msv::Plan*>(plan);
  *pl = {};
  if (win < 1 || win > n_fft || n_fft % 2 != 0 || n_mel < 1 ||
      reinterpret_cast<uintptr_t>(twiddles) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* wd = static_cast<const float*>(window);
  const float2* tw = static_cast<const float2*>(twiddles);
  const float* wt = static_cast<const float*>(wts);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wave_is_i16)
    return launch_mel<int16_t>(wave, wave_stride, wave_len, batch, wd, tw,
                               bands, woff, wt, out, win, hop, n_frames,
                               n_fft, n_mel, n_tw, pl, st);
  return launch_mel<float>(wave, wave_stride, wave_len, batch, wd, tw, bands,
                           woff, wt, out, win, hop, n_frames, n_fft, n_mel,
                           n_tw, pl, st);
}

// The linear scale's form of the same launch: no filterbank; out: (batch,
// n_frames, n_fft / 2 + 1) f32, the dB of every bin.  Arguments and return
// as msv_mel_spectrogram_fft's.
int msv_linear_spectrogram_fft(const void* wave, int wave_is_i16,
                               long long wave_stride, long long wave_len,
                               int batch, const void* window,
                               const void* twiddles, float* out, int win,
                               int hop, int n_frames, int n_fft, int n_tw,
                               void* stream, int* plan) {
  msv::Plan* pl = reinterpret_cast<msv::Plan*>(plan);
  *pl = {};
  if (win < 1 || win > n_fft || n_fft % 2 != 0 ||
      reinterpret_cast<uintptr_t>(twiddles) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* wd = static_cast<const float*>(window);
  const float2* tw = static_cast<const float2*>(twiddles);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wave_is_i16)
    return launch_linear<int16_t>(wave, wave_stride, wave_len, batch, wd, tw,
                                  out, win, hop, n_frames, n_fft, n_tw, pl,
                                  st);
  return launch_linear<float>(wave, wave_stride, wave_len, batch, wd, tw, out,
                              win, hop, n_frames, n_fft, n_tw, pl, st);
}

}  // extern "C"
