// Device helpers shared by the fused mel dB kernels: mel_spectrogram.cu
// (f32 parity mode, 3xTF32), mel_spectrogram_bf16.cu (bf16 fast mode),
// mel_spectrogram_split.cu (split-f32 mode, wgmma) and, for the parity
// mode's FFT tier, mel_spectrogram_fft.cu.  The first three stage samples,
// compute the DFT magnitude of a tile of frequency bins into shared memory,
// then run mel_tile: a sparse-band mel accumulation from shared-memory band
// tables, stores coalesced, the dB written by the tile that ends a band (in
// split form: each product as three bf16 products over hi/lo planes of the
// magnitude and the filterbank).  The FFT tier holds one frame's whole
// spectrum and runs mel_frame, the same band-sparse pass over one frame (its
// linear-scale form writes every bin's dB instead, amp_db).
//
// They share the staging ring of C/S slabs (bulk copies completing on
// mbarriers, below), the chunked tier's sample staging (parity and fast,
// for windows whose samples no block holds), the launchers' Plan and the
// leftover bin: their operands come from
// kernels/spectrogram_cuda.py::prepare_operands, which cuts C and S into
// slabs of KS rows x NB bins laid out as the ring stage's shared-memory
// image (parity and fast: C rows, then S rows, at a padded row stride;
// split: the planes Ch, Cl, Sh, Sl in the 8 x 8 core matrices a wgmma
// descriptor reads), each slab one contiguous, 16-byte aligned run of
// bytes, and keeps the last column of C and S (bin n_freq - 1 = n_fft / 2)
// apart.  Tiles then cover n_freq - 1 = 2^k bins, and the last one computes
// the leftover bin with SIMT FMAs over the kept columns: no launch walks K
// for a tile of one bin.

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

// dB of an amplitude (or a band sum) as every kernel writes it: 20 ln(v) /
// ln(10), and -360 dB at or under the 1e-18 floor.
__device__ __forceinline__ float amp_db(float v) {
  return v > kAmin ? logf(v) * kDbScale : kDbFloor;
}

__device__ __forceinline__ float to_f32(float x) { return x; }

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// A split-f32 pair as one word, the bf16 hi part in the low half, the lo
// part in the high half, and back as floats (hi, lo).
__device__ __forceinline__ uint32_t split_pack(float x) {
  const __nv_bfloat16 h = __float2bfloat16_rn(x);
  const __nv_bfloat162 p =
      __halves2bfloat162(h, __float2bfloat16_rn(x - __bfloat162float(h)));
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float2 split_unpack(uint32_t p) {
  return make_float2(__uint_as_float(p << 16),
                     __uint_as_float(p & 0xffff0000u));
}

// d += a . b on the tensor cores: one m16n8k16 tile, bf16 in, f32
// accumulate (the bf16 and split kernels' product).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 tiles from shared memory, transposed: the B fragments of
// two n-tiles of a 16-row K step.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// ---------------------------------------------------------------------------
// The staging ring: C/S slabs copied by the copy engine, one bulk copy per
// slab, each completing on its stage's mbarrier.  The fast and split
// kernels run WARPS consumer warps and one producer warp that keeps the
// ring full; the parity kernel, whose registers a ninth warp would cut to
// 168 a thread (three warps on one of the SM's four 16K-register
// partitions), refills from thread 0 after a barrier.

constexpr int kSlabRows = 16;   // C/S rows per slab (prepare_operands' KS)
constexpr int kMaxStages = 8;   // ring stages at most
constexpr int kRingOffset = 128;  // bytes of mbarriers before the ring
constexpr int kProducer = WARPS;  // the producer warp's index
static_assert(2 * kMaxStages * sizeof(uint64_t) <= kRingOffset,
              "the full and empty mbarriers fit before the ring");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// A barrier of the WARPS consumer warps alone (named barrier 1: the
// producer warp has left by then).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * WARPS) : "memory");
}

// `bytes` (a multiple of 16) from global `src` to shared `dst` (both
// 16-byte aligned) by the copy engine; `bar` completes its phase when they
// have landed.  Issued by one thread.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  // the stage was last read through the generic proxy: order those reads
  // before the async proxy's writes
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Slab q of `total` (tile-major, then K: slab q starts q * slab_bytes into
// `slabs`) staged in ring stage q % stages.  The first `stages` copies are
// issued at the start.  With a producer warp, it refills stage s with slab
// q + stages once each consumer warp has released slab q (one arrival per
// warp on the stage's `empty` mbarrier, after its last read); without one,
// thread 0 refills it after the __syncthreads that follows every warp's
// last read.  Each consumer thread walks the slabs in order with a Cursor
// (slab, stage, phase).
struct Ring {
  uint64_t* full;          // per stage: the copy has landed
  uint64_t* empty;         // per stage: every consumer warp is done with it
  unsigned char* stage0;   // stage 0's bytes; stage s at s * slab_bytes
  const unsigned char* src;
  uint32_t slab_bytes;
  int stages, total;

  struct Cursor {
    int q = 0, s = 0;
    uint32_t phase = 0;
  };

  // thread 0: barriers and the first copies (then a __syncthreads)
  __device__ void start(int tid) const {
    if (tid != 0) return;
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, WARPS);
    }
    fence_mbar_init();
    for (int q = 0; q < min(stages, total); ++q) issue(q, q);
  }
  __device__ void issue(int q, int s) const {
    bulk_load(stage0 + static_cast<size_t>(s) * slab_bytes,
              src + static_cast<size_t>(q) * slab_bytes, slab_bytes,
              full + s);
  }
  // the producer warp: every later slab, each into its stage once that
  // stage's last slab has been released
  __device__ void produce(int lane) const {
    if (lane != 0) return;
    int s = 0;
    uint32_t phase = 0;
    for (int q = stages; q < total; ++q) {
      mbar_wait(empty + s, phase);
      issue(q, s);
      if (++s == stages) {
        s = 0;
        phase ^= 1u;
      }
    }
  }
  // the cursor's slab, once it has landed
  __device__ const unsigned char* acquire(const Cursor& c) const {
    mbar_wait(full + c.s, c.phase);
    return stage0 + static_cast<size_t>(c.s) * slab_bytes;
  }
  // after this warp's last read of the cursor's slab: release its stage
  // to the producer warp and move on
  __device__ void release(Cursor& c, int lane) const {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + c.s);
    next(c);
  }
  // without a producer warp: after every warp's last read of the cursor's
  // slab, thread 0 refills its stage; move on
  __device__ void release_all(Cursor& c, int tid) const {
    __syncthreads();
    if (tid == 0 && c.q + stages < total) issue(c.q + stages, c.s);
    next(c);
  }
  __device__ void next(Cursor& c) const {
    ++c.q;
    if (++c.s == stages) {
      c.s = 0;
      c.phase ^= 1u;
    }
  }
};

// A prepare_operands record as the kernels read it (E: f32, bf16, or, for
// split, 32-bit words of two bf16): the C/S slabs, the kept columns of bin
// n_freq - 1 ((win, 2) of E), the compact filterbank, the bands' [lo, hi)
// and their offsets into it.
template <typename E>
struct Prepared {
  const E* slabs;
  const E* tail;
  const E* wts;
  const int* bands;
  const int* woff;
  const int* tile_bands;  // (n_tiles, 2): the bands [ma, mb) each tile meets
  int n_tiles, n_wts;
};

// The band tables (bands, woff, wts) as the mel pass reads them, from
// shared memory.  The split kernel's weights are 32-bit words: the bf16 hi
// part in the low half, the lo part in the high half.
template <typename E>
struct BandTables {
  const int* bands;
  const int* woff;
  const E* wts;
};

// Shared memory for the band tables: bands (2 ints a band), woff (1) and
// the compact weights, rounded up to 16 bytes.
inline size_t table_bytes(int n_mel, int n_wts, size_t esize) {
  return (12 * static_cast<size_t>(n_mel) + esize * n_wts + 15) / 16 * 16;
}

// Copy the band tables into shared memory at `dst` (the consumer threads,
// tid < 32 * WARPS; a barrier must follow before they are read).
template <typename E>
__device__ __forceinline__ BandTables<E> stage_tables(unsigned char* dst,
                                                      const Prepared<E>& ops,
                                                      int n_mel, int tid) {
  int* bands = reinterpret_cast<int*>(dst);
  int* woff = bands + 2 * n_mel;
  E* wts = reinterpret_cast<E*>(woff + n_mel);
  if (tid < 32 * WARPS) {
    for (int i = tid; i < 2 * n_mel; i += 32 * WARPS) bands[i] = ops.bands[i];
    for (int i = tid; i < n_mel; i += 32 * WARPS) woff[i] = ops.woff[i];
    for (int i = tid; i < ops.n_wts; i += 32 * WARPS) wts[i] = ops.wts[i];
  }
  return {bands, woff, wts};
}

// The kept columns (win, 2) for the leftover bin: copied into the ring's
// bytes (`ring`, `ring_bytes`), idle once every consumer has read the last
// slab, when they fit (then a consumer_sync must follow), else read where
// they are.
template <typename E>
__device__ __forceinline__ const E* stage_tail(unsigned char* ring,
                                               size_t ring_bytes,
                                               const E* tail, int win,
                                               int tid) {
  if (2 * sizeof(E) * static_cast<size_t>(win) > ring_bytes) return tail;
  E* dst = reinterpret_cast<E*>(ring);
  for (int i = tid; i < 2 * win; i += 32 * WARPS) dst[i] = tail[i];
  return dst;
}

// ---------------------------------------------------------------------------
// The chunked tier's samples: where a block cannot hold every sample of its
// frames' windows (16*MT*hop + win of them) beside the ring, it stages them
// in chunks along the window, samples [k0, k0 + len) of each of its TF
// frames, frame f's at dst[f * cs + n - k0] (one row a frame: every row
// starts at its frame's own first sample, so any hop reads aligned), uses
// them, and stages the next chunk after a barrier.  The consumer warps
// stage, two frames a warp at a time, 2 * kStageLoads loads in flight,
// each sample kept as it lies until all have landed: int16 samples
// converted as each load landed made the int16 route 1.56 times slower
// than f32 at 384 kHz (491 against 314 ms a 300 s track on an H100 80GB
// HBM3 at 700 W; 322 ms once converted after).

constexpr int kStageLoads = 16;  // sample loads in flight per thread and frame

__device__ __forceinline__ float to_smem(float v, float*) { return v; }

__device__ __forceinline__ __nv_bfloat16 to_smem(float v, __nv_bfloat16*) {
  return __float2bfloat16_rn(v);
}

template <int TF, typename S, typename T>
__device__ __forceinline__ void stage_chunk(S* dst, int cs,
                                            const T* __restrict__ w,
                                            long long base, int hop,
                                            long long wave_len, int k0,
                                            int len, int lane, int warp) {
  static_assert(TF % (2 * WARPS) == 0, "two frames a warp at a time");
  for (int f = warp; f < TF; f += 2 * WARPS) {
    for (int cb = 0; cb < len; cb += 32 * kStageLoads) {
      // all loads in flight, as they lie, before any conversion or store
      T v[2][kStageLoads];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long g0 =
            base + static_cast<long long>(f + h * WARPS) * hop + k0;
#pragma unroll
        for (int u = 0; u < kStageLoads; ++u) {
          const int c = cb + lane + 32 * u;
          v[h][u] = c < len && g0 + c < wave_len ? w[g0 + c] : T(0);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int u = 0; u < kStageLoads; ++u) {
          const int c = cb + lane + 32 * u;
          if (c < len)
            dst[(f + h * WARPS) * cs + c] = to_smem(load_sample(v[h], u), dst);
        }
    }
  }
}

// ---------------------------------------------------------------------------
// What a launcher chose, for the wrapper (kernels/spectrogram_cuda.py puts
// it on the launch's span): the tier (kNoTier where none fits: nothing was
// launched and `smem` is the least a block would need), the m-tiles, the
// ring's stages, the chunk's samples (chunked tier), the block's shared
// memory and the most a block may use.  kFft is the parity launch's third
// tier (mel_spectrogram_fft.cu), which takes no C/S slabs.
enum Tier : int { kNoTier = 0, kResident = 1, kChunked = 2, kFft = 3 };

struct Plan {
  int tier, mt, stages, chunk, smem, avail;
};

// Shared memory the card offers: per block (opt-in), per SM, and reserved
// by the runtime per resident block.
struct SmemLimits {
  size_t block, sm, reserved;
};

inline int smem_limits(SmemLimits* lim) {
  int dev = 0, block = 0, sm = 0, reserved = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&block,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  *lim = {static_cast<size_t>(block), static_cast<size_t>(sm),
          static_cast<size_t>(reserved)};
  return static_cast<int>(err);
}

// The ring's depth for a block whose other shared memory is `fixed` bytes:
// 0 if three stages do not fit; else three, and more (up to kMaxStages)
// while the block still fits as many times on an SM as with three.
inline int ring_stages(size_t fixed, size_t slab, const SmemLimits& lim) {
  auto bytes = [&](int st) { return fixed + st * slab; };
  if (bytes(3) > lim.block) return 0;
  auto per_sm = [&](int st) { return lim.sm / (bytes(st) + lim.reserved); };
  int st = 3;
  while (st < kMaxStages && bytes(st + 1) <= lim.block &&
         per_sm(st + 1) == per_sm(3))
    ++st;
  return st;
}

// ---------------------------------------------------------------------------
// The leftover bin n_freq - 1.

__device__ __forceinline__ float2 load_pair(const float* p, int n) {
  return reinterpret_cast<const float2*>(p)[n];
}

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p, int n) {
  return __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(p)[n]);
}

// (re, im) of the leftover bin for frame tid / P of the block's TF frames,
// P = 32 * WARPS / TF threads a frame: re = sum over n < win of x[n] *
// tail[n][0], im likewise with tail[n][1], f32 FMA.  Staged samples sit in
// rows at stride `hs`, row r starting at sample r * hop (frame f's sample n
// in row f + n / hop, column n % hop; hs == hop is the plain layout).  Each
// of a frame's P threads sums every P-th sample in increasing order (row by
// row, four in flight), and a butterfly adds the P partial sums: a fixed
// order, so every lane of the frame gets the same bits.
template <int TF, typename SampleT, typename TailT>
__device__ __forceinline__ float2 leftover_bin(const SampleT* chunk, int hs,
                                               int hop,
                                               const TailT* __restrict__ tail,
                                               int win, int tid) {
  constexpr int P = 32 * WARPS / TF;
  static_assert(P >= 1 && P <= 32 && (P & (P - 1)) == 0, "P: 1 to 32");
  const int f = tid / P, p = tid % P;
  float re = 0.0f, im = 0.0f;
  for (int r = 0, n0 = 0; n0 < win; ++r, n0 += hop) {
    const SampleT* x = chunk + static_cast<long long>(f + r) * hs - n0;
    const int end = min(win, n0 + hop);
#pragma unroll 4
    for (int n = n0 + ((p - n0) % P + P) % P; n < end; n += P) {
      const float v = to_f32(x[n]);
      const float2 cs = load_pair(tail, n);
      re = fmaf(v, cs.x, re);
      im = fmaf(v, cs.y, im);
    }
  }
#pragma unroll
  for (int o = P / 2; o > 0; o /= 2) {
    re += __shfl_xor_sync(0xffffffffu, re, o);
    im += __shfl_xor_sync(0xffffffffu, im, o);
  }
  return make_float2(re, im);
}

// ---------------------------------------------------------------------------
// The mel pass over one frequency tile, bins [k0, k0 + kt): out[f][m] (+)=
// sum over band m's bins k in the tile of mag[k - k0][f] * fb[k][m].  A
// Slaney band covers a contiguous run of bins (`bands` gives [lo, hi) per
// band), so only those bins are multiplied: about 2*n_freq FMAs a frame
// instead of n_freq*n_mel, and the skipped products are exact zeros.  The
// filterbank of prepare_operands is staged in shared memory, each band's
// weights contiguous: bin k of band m at wts[woff[m] + k - lo].  SPLIT:
// magnitudes and weights are packed hi/lo pairs (split_pack) and each bin
// adds mh*wl + ml*wh + mh*wh: bf16 products, exact in f32, lo*lo dropped.  Lane l takes bands ma + l,
// ma + l + 32, ... of the tile's range [ma, mb), warp w frames w, w + 8,
// ...: a warp's stores of one frame are consecutive bands, 128 contiguous
// bytes.  Each (frame, band) sum has one owner thread adding bins in
// increasing order (no atomics, deterministic); the tile holding a band's
// first bin stores, later tiles add, and the tile holding its last bin
// writes it as dB, so no epilogue pass reads the sums back.  `mag` holds
// bin k - k0 of frame f at (k - k0) * MS + f: MS is TF plus one word, so
// lanes at different bins read different banks.

template <int TF, typename MagT>
__host__ __device__ constexpr int mag_stride() {
  return TF + 4 / static_cast<int>(sizeof(MagT));
}

template <int TF, bool SPLIT = false, typename MagT, typename WT>
__device__ __forceinline__ void mel_tile(const MagT* mag,
                                         const BandTables<WT>& tb, int ma,
                                         int mb, float* o, int k0, int kt,
                                         int n_mel, int nf, int lane,
                                         int warp) {
  constexpr int MS = mag_stride<TF, MagT>();
  const int k1 = k0 + kt;
  for (int m = ma + lane; m < mb; m += 32) {
    const int lo = tb.bands[2 * m], hi = tb.bands[2 * m + 1];
    const int ks = max(lo, k0), ke = min(hi, k1);
    if (ks >= ke) continue;
    const WT* w = tb.wts + (tb.woff[m] - lo);  // w[k]: bin k's weight
    const MagT* x = mag - k0 * MS;             // x[k * MS + f]
    for (int f = warp; f < nf; f += WARPS) {
      float part = 0.0f;
      for (int k = ks; k < ke; ++k) {
        if constexpr (SPLIT) {
          const float2 xs = split_unpack(x[k * MS + f]);
          const float2 ws = split_unpack(w[k]);
          part = fmaf(xs.x, ws.y, part);  // small terms first
          part = fmaf(xs.y, ws.x, part);
          part = fmaf(xs.x, ws.x, part);
        } else {
          part = fmaf(to_f32(x[k * MS + f]), to_f32(w[k]), part);
        }
      }
      float* dst = o + static_cast<long long>(f) * n_mel + m;
      const float v = lo >= k0 ? part : *dst + part;
      *dst = hi > k1 ? v : (v > kAmin ? logf(v) * kDbScale : kDbFloor);
    }
  }
}

// Bands with no support (an all-zero filterbank column) as dB: -360.
template <int TF>
__device__ __forceinline__ void mel_empty_bands(float* o, const int* bands,
                                                int n_mel, int nf, int lane,
                                                int warp) {
  constexpr int FPL = (TF + 31) / 32;
  for (int m = warp; m < n_mel; m += WARPS) {
    if (bands[2 * m] < bands[2 * m + 1]) continue;
#pragma unroll
    for (int h = 0; h < FPL; ++h) {
      const int f = h * 32 + lane;
      if (f < nf) o[static_cast<long long>(f) * n_mel + m] = kDbFloor;
    }
  }
}

// The mel pass of one frame (the FFT tier's: a block per frame), its
// magnitudes contiguous in shared memory, mag[k] for k < n_freq.  The band
// tables (bands, woff) are staged in shared memory at `tab` (3 * n_mel
// ints).  Warp w of the block's NW takes BPW consecutive bands at a time,
// w * BPW + NW * BPW * i on: lane l sums bins lo + l, lo + l + 32, ... of
// each in increasing order, the BPW bands' loads in flight together, weights
// read where they are in device memory (coalesced: a band's weights are
// contiguous), and a fixed butterfly adds the 32 partial sums, so every lane
// gets the same bits: deterministic, no atomics, and the int16 route
// bit-equal to the f32 route.  The sums go to `sums` in shared memory
// (n_mel floats), and after a barrier the block writes the frame's row of
// dB `o` with coalesced stores.  Bands with no support read 0: -360 dB.
template <int NW, int BPW>
__device__ __forceinline__ void mel_frame(const float* mag, int* tab,
                                          float* sums,
                                          const int* __restrict__ bands,
                                          const int* __restrict__ woff,
                                          const float* __restrict__ wts,
                                          float* __restrict__ o, int n_mel,
                                          int tid) {
  int* sband = tab;           // [lo, hi) of band m at 2m
  int* soff = tab + 2 * n_mel;
  for (int i = tid; i < 2 * n_mel; i += 32 * NW) sband[i] = __ldg(bands + i);
  for (int i = tid; i < n_mel; i += 32 * NW) soff[i] = __ldg(woff + i);
  __syncthreads();
  const int lane = tid & 31, warp = tid >> 5;
  for (int m0 = warp * BPW; m0 < n_mel; m0 += NW * BPW) {
    int lo[BPW], len[BPW], most = 0;
    const float* w[BPW];
    float part[BPW];
#pragma unroll
    for (int u = 0; u < BPW; ++u) {
      const int m = m0 + u;
      lo[u] = m < n_mel ? sband[2 * m] : 0;
      len[u] = m < n_mel ? sband[2 * m + 1] - lo[u] : 0;
      w[u] = wts + (m < n_mel ? soff[m] : 0);  // w[u][i]: bin lo + i
      part[u] = 0.0f;
      most = max(most, len[u]);
    }
    for (int i = lane; i < most; i += 32) {
#pragma unroll
      for (int u = 0; u < BPW; ++u)
        if (i < len[u]) part[u] = fmaf(mag[lo[u] + i], __ldg(w[u] + i),
                                       part[u]);
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
#pragma unroll
      for (int u = 0; u < BPW; ++u)
        part[u] += __shfl_xor_sync(0xffffffffu, part[u], s);
    if (lane == 0) {
#pragma unroll
      for (int u = 0; u < BPW; ++u)
        if (m0 + u < n_mel) sums[m0 + u] = part[u];
    }
  }
  __syncthreads();
  for (int m = tid; m < n_mel; m += 32 * NW) {
    o[m] = amp_db(sums[m]);
  }
}

}  // namespace msv
