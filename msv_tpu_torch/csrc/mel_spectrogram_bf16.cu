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
// (7.9 MFLOP at 48 kHz), 92% of the work: 189 GFLOP for 240 s at 48 kHz,
// 0.19 ms at the 989 TFLOP/s dense bf16 peak, against about 0.05 GB of
// HBM traffic (0.015 ms).  C and S (7.9 MB in bf16 at 48 kHz) stay in L2 and
// every block re-reads them, 64 FLOPs per byte staged: the staging of
// C/S, not tensor-core issue, bounded the earlier design (each 32-row slab
// loaded with 2-byte loads between two barriers, one block per SM: 2.9 ms
// at 48 kHz on an H100 80GB HBM3 at 700 W, 6.6% of the bound).  Measured on
// that card now (kernels/probe.py, 48 kHz, B = 1): 0.8 ms, of which the
// products take 0.5 ms (mma.sync at about 39% of the bf16 peak), the ring
// 0.05 ms and the SIMT parts (staging, the leftover bin, the mel pass) 0.25
// ms.  The lever is wgmma (the full rate), then fewer SIMT passes.
//
// What the design does about it:
//  * C and S arrive through mel_common.cuh's ring: prepare_operands lays
//    them out as slabs of KS = 16 rows x NB = 256 bins (C rows then S rows,
//    row stride 264 bf16 = 33 x 16 bytes, so the 8 rows an ldmatrix reads
//    fall in 8 different bank groups), one bulk copy per slab, at least
//    three in flight: the copy engine stages slab j + 2 while the warps
//    multiply slab j.  A ninth warp is the producer: it refills a stage as
//    soon as all 8 consumer warps have arrived on its `empty` mbarrier, so
//    no block-wide barrier stands between slabs.
//  * One block per (tile of TF = 16*MT frames, batch row), 8 consumer
//    warps and the producer.  Each consumer warp owns all TF frames and 32
//    of the NB frequency columns of the current tile, so every A fragment
//    it loads feeds 4 n-tiles x 2 matrices of mma.sync.m16n8k16 (bf16 in,
//    f32 accumulate): 8*MT independent mma per slab; B fragments are read
//    with ldmatrix.x4.trans.
//  * The block stages its samples once, rounded to bf16, in overlapping
//    rows: row r holds the R >= hop + 16 samples from r*hop on, at a row
//    stride of 8 mod 16 elements (4 mod 8 words, so the A-fragment reads of
//    frames g = 0..7 hit 32 banks).  Frame f's samples n0..n0+15 of a k-step
//    sit in row f + j, j = n0/hop, from column c0 = n0 - j*hop: one offset
//    for the whole warp.  For odd hops c0 can be odd, and a bf16 pair at an
//    odd column is no aligned 32-bit word: so odd hops stage a second copy
//    shifted by one sample, read when c0 is odd, and every A register is
//    one aligned 32-bit load.
//  * Tiles cover n_freq - 1 = n_fft/2 bins; the last one adds the leftover
//    bin n_freq - 1 with SIMT f32 FMAs on the bf16 samples and the bf16
//    kept columns (the same function: bf16 products are exact in f32) as
//    one more magnitude column.  No launch walks K for a tile of one bin.
//  * The magnitude is rounded to bf16 and stored per tile in shared memory;
//    the mel product then walks only each band's nonzero bins, from the
//    compact filterbank of prepare_operands, one owner thread per (frame,
//    band), adding bins in increasing order: no atomics, deterministic, and
//    the int16 route is bit-equal to the f32 route.  A band's sum is written
//    as dB in the tile that holds its last bin (mel_common.cuh's mel_tile,
//    shared with the parity kernel).
//  * MT (4, 2, then 1) is the largest whose samples (two copies for odd
//    hops), magnitude tile and three ring stages fit the card's shared
//    memory; the ring then deepens while as many blocks still fit on an SM.
//
// The chunked tier (mel_db_bf16_chunked_kernel), for windows whose bf16
// samples no block holds beside the band tables: 384 kHz at the session's
// settings (626 KB at MT 4, 240 KB at MT 1, against the 227 KB a block may
// use); up to 250 kHz MT 1 or 2 still fits.  Its shared memory is bounded
// whatever the window: the ring, the magnitude tile and one chunk of kc
// bf16 samples for each of the TF frames, 2 B * TF * (kc + 8); the band
// tables and the leftover bin's kept columns are read from device memory.
// The launcher takes it where no resident MT fits, with one plan whatever
// the shape (CHUNK_MT and CHUNK): MT 4, kc 1024, 211.8 KB with three
// stages, the most m-tiles and then the longest power-of-two chunk that
// fit an H100's block.  Its staging between two barriers of the consumer
// warps does not overlap the products, which at bf16 rates it cannot hide:
// measured (kernels/probe.py, NVIDIA H100 80GB HBM3 at 700 W, B = 1, f32
// input, 6001 frames of 60 s) 27.4 ms at 384 kHz; forced on where the
// resident tier fits, 0.525 ms at 48 kHz against its 0.304.

#include "mel_common.cuh"

namespace {

using msv::WARPS;
using msv::ldmatrix_x4_trans;
using msv::mma_bf16;
constexpr int KS = msv::kSlabRows;  // C/S rows per slab: one k16 step
constexpr int WCOLS = 32;           // frequency columns per warp
constexpr int NB = WARPS * WCOLS;   // frequency columns per tile
constexpr int NBP = NB + 8;         // slab row stride (bf16)
constexpr uint32_t SLAB_BYTES = 2 * KS * NBP * sizeof(__nv_bfloat16);
constexpr int STAGE_LOADS = 16;     // sample loads in flight per thread
constexpr int CHUNK_MT = 4;         // the chunked tier's m-tiles
constexpr int CHUNK = 1024;        // and its samples a frame a chunk
static_assert(KS == 16, "one mma k-step per slab");
static_assert(SLAB_BYTES % 16 == 0, "bulk copies move 16-byte multiples");

// One slab (a k16 step) into the sums: the B fragments of the warp's 4
// n-tiles of C and S (ldmatrix, rows brow, columns bcol on) times the A
// fragments of its MT m-tiles (frame rows at arow, samples from x on).
template <int MT>
__device__ __forceinline__ void slab_mma(float (&re)[MT][4][4],
                                         float (&im)[MT][4][4],
                                         const __nv_bfloat16* cs,
                                         const __nv_bfloat16* x,
                                         const int (&arow)[MT][2], int brow,
                                         int bcol) {
  uint32_t bc[2][4], bs[2][4];
#pragma unroll
  for (int pr = 0; pr < 2; ++pr) {
    ldmatrix_x4_trans(bc[pr], cs + brow * NBP + bcol + pr * 16);
    ldmatrix_x4_trans(bs[pr], cs + (KS + brow) * NBP + bcol + pr * 16);
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    uint32_t a[4];
    a[0] = *reinterpret_cast<const uint32_t*>(x + arow[mt][0]);
    a[1] = *reinterpret_cast<const uint32_t*>(x + arow[mt][1]);
    a[2] = *reinterpret_cast<const uint32_t*>(x + arow[mt][0] + 8);
    a[3] = *reinterpret_cast<const uint32_t*>(x + arow[mt][1] + 8);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int pr = nt >> 1, hi = (nt & 1) * 2;
      mma_bf16(re[mt][nt], a, bc[pr][hi], bc[pr][hi + 1]);
      mma_bf16(im[mt][nt], a, bs[pr][hi], bs[pr][hi + 1]);
    }
  }
}

// |X| rounded to bf16 into mag[col][frame] for the columns [0, nv) of the
// tile that this warp's sums cover.
template <int MT>
__device__ __forceinline__ void store_magnitude(__nv_bfloat16* mag,
                                                const float (&re)[MT][4][4],
                                                const float (&im)[MT][4][4],
                                                int nv, int wn0, int g,
                                                int tig) {
  constexpr int MS = msv::mag_stride<16 * MT, __nv_bfloat16>();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = wn0 + nt * 8 + tig * 2 + (q & 1);
        if (col < nv) {
          const int f = mt * 16 + g + (q >> 1) * 8;
          const float x = re[mt][nt][q], y = im[mt][nt][q];
          mag[col * MS + f] = __float2bfloat16_rn(sqrtf(x * x + y * y));
        }
      }
    }
  }
}

// Samples per staged row: hop and the 16 a k-step reads past a row's own
// hop samples, rounded up to 8.
__host__ __device__ __forceinline__ int row_len(int hop) {
  return (hop + 16 + 7) / 8 * 8;
}

// Row stride of the staged samples: 8 mod 16 elements (4 mod 8 words), so
// that 8 frames' rows start in 8 distinct 4-bank groups.
__host__ __device__ __forceinline__ int sample_stride(int hop) {
  return (row_len(hop) + 15) / 16 * 16 + 8;
}

// Where the band tables start: after the mbarriers, the ring, the bf16
// magnitude tile (NB + 1 bins) and the staged sample rows through frame
// TF-1's window rounded up to whole slabs (two copies for odd hops), at a
// 16-byte boundary.
__host__ __device__ __forceinline__ size_t tables_offset(int mt, int win,
                                                         int hop,
                                                         int stages) {
  const size_t copies = (hop & 1) ? 2 : 1;
  const int win_p = (win + KS - 1) / KS * KS;
  const size_t rows = 16 * mt + (win_p - 1) / hop;
  const size_t end =
      msv::kRingOffset + stages * SLAB_BYTES +
      sizeof(__nv_bfloat16) * (static_cast<size_t>(NB + 1) * (16 * mt + 2) +
                               copies * rows * sample_stride(hop));
  return (end + 15) / 16 * 16;
}

// Where the chunked tier's samples start: after the mbarriers, the ring and
// the bf16 magnitude tile, at a 16-byte boundary.
__host__ __device__ __forceinline__ size_t chunk_offset(int mt, int stages) {
  const size_t end = msv::kRingOffset + stages * SLAB_BYTES +
                     sizeof(__nv_bfloat16) * (NB + 1) *
                         static_cast<size_t>(16 * mt + 2);
  return (end + 15) / 16 * 16;
}

// MT m-tiles of 16 frames per block; every warp covers all of them.
template <typename T, int MT>
__global__ void __launch_bounds__(32 * (WARPS + 1))
mel_db_bf16_kernel(const T* __restrict__ wave, long long wave_stride,
                   long long wave_len, const msv::Prepared<__nv_bfloat16> ops,
                   float* __restrict__ out, int win, int hop, int n_frames,
                   int n_freq, int n_mel, int stages) {
  constexpr int TF = 16 * MT;
  constexpr int P = 32 * WARPS / TF;  // threads per frame, leftover bin
  extern __shared__ __align__(128) unsigned char smem[];
  const int n_k = (win + KS - 1) / KS;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  const msv::Ring ring{bars, bars + msv::kMaxStages, smem + msv::kRingOffset,
                       reinterpret_cast<const unsigned char*>(ops.slabs),
                       SLAB_BYTES, stages, ops.n_tiles * n_k};
  constexpr int MS = msv::mag_stride<TF, __nv_bfloat16>();
  __nv_bfloat16* mag = reinterpret_cast<__nv_bfloat16*>(
      smem + msv::kRingOffset + stages * SLAB_BYTES);  // [NB + 1][MS]
  const int rl = row_len(hop), hs = sample_stride(hop);
  const int rows = TF + (n_k * KS - 1) / hop;
  __nv_bfloat16* chunk0 = mag + (NB + 1) * MS;  // overlapping sample rows
  __nv_bfloat16* chunk1 = chunk0 + rows * hs;   // shifted by 1 (odd hops)
  unsigned char* tables = smem + tables_offset(MT, win, hop, stages);

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * 32 + lane;
  const int g = lane >> 2;   // mma group: fragment row / B column
  const int tig = lane & 3;  // thread in group: fragment column pair
  const int f0 = blockIdx.x * TF;
  const T* w = wave + static_cast<long long>(blockIdx.y) * wave_stride;
  const long long base = static_cast<long long>(f0) * hop;
  const bool odd = hop & 1;

  ring.start(tid);
  // the consumer warps stage the samples: row r holds samples r*hop on
  for (int r = warp; r < rows && warp < WARPS; r += WARPS) {
    const long long g0 = base + static_cast<long long>(r) * hop;
    // warp-uniform batches (the shuffles below need every lane)
    for (int cb = 0; cb < rl; cb += 32 * STAGE_LOADS) {
      // all loads in flight before the stores: sample c of the row for
      // c = cb + lane + 32u, and, for the shifted copy, sample c + 1 (the
      // next lane's, or lane 0's of the next u for lane 31)
      float v[STAGE_LOADS + 1];
#pragma unroll
      for (int u = 0; u <= STAGE_LOADS; ++u) {
        const int c = cb + lane + 32 * u;
        v[u] = (u < STAGE_LOADS || odd) && c <= rl && g0 + c < wave_len
                   ? msv::load_sample(w, g0 + c)
                   : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < STAGE_LOADS; ++u) {
        const int c = cb + lane + 32 * u;
        if (c < rl) chunk0[r * hs + c] = __float2bfloat16_rn(v[u]);
      }
      if (odd) {
#pragma unroll
        for (int u = 0; u < STAGE_LOADS; ++u) {
          const float up = __shfl_down_sync(0xffffffffu, v[u], 1);
          const float nx = __shfl_sync(0xffffffffu, v[u + 1], 0);
          const int c = cb + lane + 32 * u;
          if (c < rl)
            chunk1[r * hs + c] = __float2bfloat16_rn(lane == 31 ? nx : up);
        }
      }
    }
  }
  const msv::BandTables<__nv_bfloat16> tb =
      msv::stage_tables(tables, ops, n_mel, tid);
  __syncthreads();
  if (warp == msv::kProducer) {  // the producer warp keeps the ring full
    ring.produce(lane);
    return;
  }
  // this thread's A rows: frames mt*16 + g and mt*16 + g + 8, column 2*tig
  int arow[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) arow[mt][h] = (mt * 16 + g + 8 * h) * hs + 2 * tig;

  float* o = out + (static_cast<long long>(blockIdx.y) * n_frames + f0) * n_mel;
  const int nf = min(TF, n_frames - f0);
  const int wn0 = warp * WCOLS;  // this warp's first column in the tile
  // B fragment rows and columns this lane addresses for ldmatrix
  const int brow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int bcol = wn0 + (lane >> 4) * 8;
  msv::Ring::Cursor cur;

  for (int t = 0; t < ops.n_tiles; ++t) {
    float re[MT][4][4], im[MT][4][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int q = 0; q < 4; ++q) re[mt][nt][q] = im[mt][nt][q] = 0.0f;
      }
    }

    // the k-step's samples n0..n0+15 of every frame: row offset j (as
    // roff) and column c0 = n0 - j*hop; uniform across the warp
    int roff = 0, c0 = 0;
    for (int j = 0; j < n_k; ++j) {
      const auto* cs =
          reinterpret_cast<const __nv_bfloat16*>(ring.acquire(cur));
      // an odd c0 reads the shifted copy one column back: an even column
      const __nv_bfloat16* x =
          ((c0 & 1) ? chunk1 + (c0 - 1) : chunk0 + c0) + roff;
      slab_mma<MT>(re, im, cs, x, arow, brow, bcol);
      ring.release(cur, lane);
      c0 += KS;
      while (c0 >= hop) {  // the next row
        c0 -= hop;
        roff += hs;
      }
    }

    // every warp is done with the last tile's mel pass and these slabs
    msv::consumer_sync();
    // |X| rounded to bf16 into mag[col][frame], for the bins the products
    // cover
    const int k0 = t * NB;
    const int nv = min(NB, n_freq - 1 - k0);
    store_magnitude<MT>(mag, re, im, nv, wn0, g, tig);
    int kt = NB;
    if (t == ops.n_tiles - 1) {  // the leftover bin n_freq - 1, column nv
      const __nv_bfloat16* tl = msv::stage_tail(
          smem + msv::kRingOffset, stages * SLAB_BYTES, ops.tail, win, tid);
      msv::consumer_sync();
      const float2 v = msv::leftover_bin<TF>(chunk0, hs, hop, tl, win, tid);
      if (tid % P == 0)
        mag[nv * MS + tid / P] =
            __float2bfloat16_rn(sqrtf(v.x * v.x + v.y * v.y));
      kt = nv + 1;
    }
    msv::consumer_sync();

    msv::mel_tile<TF>(mag, tb, __ldg(ops.tile_bands + 2 * t),
                      __ldg(ops.tile_bands + 2 * t + 1), o, k0, kt, n_mel,
                      nf, lane, warp);
  }
  msv::mel_empty_bands<TF>(o, tb.bands, n_mel, nf, lane, warp);
}

// The chunked tier: the kernel above for blocks that cannot hold every
// sample of their frames' windows.  The consumer warps stage the samples in
// chunks of kc along the window, rounded to bf16 (msv::stage_chunk: one row
// of kc + 8 elements a frame, 4 mod 8 words; every row starts at its
// frame's first sample, so each k-step's column is even and odd hops need
// no shifted copy), again for every frequency tile, between two barriers of
// the consumer warps; the producer warp keeps the ring full throughout.
// The band tables are read where they are in device memory (L1 and L2 keep
// them), not copied into shared memory; the leftover bin sums chunk by
// chunk in the last tile, with its kept columns read from device memory.
// The products, the magnitude, the mel pass and the dB are the kernel
// above's.
__host__ __device__ __forceinline__ int chunk_stride(int kc) { return kc + 8; }

template <typename T, int MT>
__global__ void __launch_bounds__(32 * (WARPS + 1))
mel_db_bf16_chunked_kernel(const T* __restrict__ wave, long long wave_stride,
                           long long wave_len,
                           const msv::Prepared<__nv_bfloat16> ops,
                           float* __restrict__ out, int win, int hop,
                           int n_frames, int n_freq, int n_mel, int stages,
                           int kc) {
  constexpr int TF = 16 * MT;
  constexpr int P = 32 * WARPS / TF;  // threads per frame, leftover bin
  extern __shared__ __align__(128) unsigned char smem[];
  const int win_p = (win + KS - 1) / KS * KS;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  const msv::Ring ring{bars, bars + msv::kMaxStages, smem + msv::kRingOffset,
                       reinterpret_cast<const unsigned char*>(ops.slabs),
                       SLAB_BYTES, stages, ops.n_tiles * (win_p / KS)};
  constexpr int MS = msv::mag_stride<TF, __nv_bfloat16>();
  __nv_bfloat16* mag = reinterpret_cast<__nv_bfloat16*>(
      smem + msv::kRingOffset + stages * SLAB_BYTES);  // [NB + 1][MS]
  __nv_bfloat16* chunk = reinterpret_cast<__nv_bfloat16*>(
      smem + chunk_offset(MT, stages));  // frame f's samples at f * cs
  const int cs = chunk_stride(kc);
  const msv::BandTables<__nv_bfloat16> tb{ops.bands, ops.woff, ops.wts};

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * 32 + lane;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int f0 = blockIdx.x * TF;
  const T* w = wave + static_cast<long long>(blockIdx.y) * wave_stride;
  const long long base = static_cast<long long>(f0) * hop;

  ring.start(tid);
  __syncthreads();  // the ring's mbarriers are initialised
  if (warp == msv::kProducer) {  // the producer warp keeps the ring full
    ring.produce(lane);
    return;
  }
  int arow[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      arow[mt][h] = (mt * 16 + g + 8 * h) * cs + 2 * tig;

  float* o = out + (static_cast<long long>(blockIdx.y) * n_frames + f0) * n_mel;
  const int nf = min(TF, n_frames - f0);
  const int wn0 = warp * WCOLS;
  const int brow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int bcol = wn0 + (lane >> 4) * 8;
  msv::Ring::Cursor cur;

  for (int t = 0; t < ops.n_tiles; ++t) {
    const bool last = t == ops.n_tiles - 1;
    float re[MT][4][4], im[MT][4][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int q = 0; q < 4; ++q) re[mt][nt][q] = im[mt][nt][q] = 0.0f;
      }
    }
    float2 left = make_float2(0.0f, 0.0f);  // the leftover bin, last tile

    for (int k0 = 0; k0 < win_p; k0 += kc) {
      const int len = min(kc, win_p - k0);
      msv::consumer_sync();  // every consumer warp is done with the last chunk
      msv::stage_chunk<TF>(chunk, cs, w, base, hop, wave_len, k0, len, lane,
                           warp);
      msv::consumer_sync();
      if (last) {  // samples [k0, k0 + nl) of the kept columns
        const int nl = min(len, win - k0);
        const float2 v =
            msv::leftover_bin<TF>(chunk, cs, nl, ops.tail + 2 * k0, nl, tid);
        left.x += v.x;
        left.y += v.y;
      }
      for (int j = 0; j < len; j += KS) {
        const auto* cs_ =
            reinterpret_cast<const __nv_bfloat16*>(ring.acquire(cur));
        slab_mma<MT>(re, im, cs_, chunk + j, arow, brow, bcol);
        ring.release(cur, lane);
      }
    }

    // every warp is done with the last tile's mel pass and these slabs
    msv::consumer_sync();
    const int k0 = t * NB;
    const int nv = min(NB, n_freq - 1 - k0);
    store_magnitude<MT>(mag, re, im, nv, wn0, g, tig);
    int kt = NB;
    if (last) {  // the leftover bin n_freq - 1, column nv
      if (tid % P == 0)
        mag[nv * MS + tid / P] =
            __float2bfloat16_rn(sqrtf(left.x * left.x + left.y * left.y));
      kt = nv + 1;
    }
    msv::consumer_sync();

    msv::mel_tile<TF>(mag, tb, __ldg(ops.tile_bands + 2 * t),
                      __ldg(ops.tile_bands + 2 * t + 1), o, k0, kt, n_mel,
                      nf, lane, warp);
  }
  msv::mel_empty_bands<TF>(o, tb.bands, n_mel, nf, lane, warp);
}

// Shared memory besides the ring: resident tier.
size_t fixed_bytes(int mt, int win, int hop, int n_mel, int n_wts) {
  return tables_offset(mt, win, hop, 0) +
         msv::table_bytes(n_mel, n_wts, sizeof(__nv_bfloat16));
}

// Shared memory besides the ring: chunked tier.
size_t chunked_fixed_bytes(int mt, int kc) {
  return chunk_offset(mt, 0) +
         sizeof(__nv_bfloat16) * static_cast<size_t>(16 * mt) *
             chunk_stride(kc);
}

template <typename T, int MT>
int launch_mt(const void* wave, long long wave_stride, long long wave_len,
              int batch, const msv::Prepared<__nv_bfloat16>& ops, float* out,
              int win, int hop, int n_frames, int n_freq, int n_mel,
              int stages, int kc, msv::Plan* plan, cudaStream_t stream) {
  const bool chunked = kc > 0;
  const size_t smem =
      (chunked ? chunked_fixed_bytes(MT, kc)
               : fixed_bytes(MT, win, hop, n_mel, ops.n_wts)) +
      stages * SLAB_BYTES;
  *plan = {chunked ? msv::kChunked : msv::kResident, MT, stages, kc,
           static_cast<int>(smem), plan->avail};
  const int tf = 16 * MT;
  const dim3 grid((n_frames + tf - 1) / tf, batch);
  const dim3 block(32, WARPS + 1);  // and the producer warp
  const T* w = static_cast<const T*>(wave);
  cudaError_t err;
  if (chunked) {
    err = cudaFuncSetAttribute(mel_db_bf16_chunked_kernel<T, MT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    mel_db_bf16_chunked_kernel<T, MT><<<grid, block, smem, stream>>>(
        w, wave_stride, wave_len, ops, out, win, hop, n_frames, n_freq,
        n_mel, stages, kc);
  } else {
    err = cudaFuncSetAttribute(mel_db_bf16_kernel<T, MT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    mel_db_bf16_kernel<T, MT><<<grid, block, smem, stream>>>(
        w, wave_stride, wave_len, ops, out, win, hop, n_frames, n_freq,
        n_mel, stages);
  }
  return static_cast<int>(cudaGetLastError());
}

// The resident tier: the most m-tiles (4, 2, then 1) whose block fits with
// a ring of three stages.  Else the chunked tier's one plan, where it fits
// with three stages.  Else nothing is launched.
template <typename T>
int launch(const void* wave, long long wave_stride, long long wave_len,
           int batch, const msv::Prepared<__nv_bfloat16>& ops, float* out,
           int win, int hop, int n_frames, int n_freq, int n_mel,
           msv::Plan* plan, cudaStream_t stream) {
  msv::SmemLimits lim;
  if (const int err = msv::smem_limits(&lim)) return err;
  plan->avail = static_cast<int>(lim.block);
#define MSV_LAUNCH(M, KC, FIXED)                                            \
  if (const int st = msv::ring_stages(FIXED, SLAB_BYTES, lim))             \
    return launch_mt<T, M>(wave, wave_stride, wave_len, batch, ops, out,   \
                           win, hop, n_frames, n_freq, n_mel, st, KC, plan, \
                           stream);
  MSV_LAUNCH(4, 0, fixed_bytes(4, win, hop, n_mel, ops.n_wts))
  MSV_LAUNCH(2, 0, fixed_bytes(2, win, hop, n_mel, ops.n_wts))
  MSV_LAUNCH(1, 0, fixed_bytes(1, win, hop, n_mel, ops.n_wts))
  MSV_LAUNCH(CHUNK_MT, CHUNK, chunked_fixed_bytes(CHUNK_MT, CHUNK))
#undef MSV_LAUNCH
  plan->smem = static_cast<int>(chunked_fixed_bytes(CHUNK_MT, CHUNK) +
                                3 * SLAB_BYTES);
  return static_cast<int>(cudaErrorInvalidConfiguration);
}

}  // namespace

extern "C" {

// The arguments of msv_mel_spectrogram, with the prepared record in bf16
// (slabs, tail and wts; the row stride must be this kernel's NBP), and
// plan as there.  Launches on `stream` without synchronising; returns the
// launch's cudaError_t.
int msv_mel_spectrogram_bf16(const void* wave, int wave_is_i16,
                             long long wave_stride, long long wave_len,
                             int batch, const void* slabs, const void* tail,
                             const void* wts, const int* bands,
                             const int* woff, const int* tile_bands,
                             float* out, int win, int hop,
                             int n_frames, int n_freq, int n_mel, int n_tiles,
                             int n_wts, int ks, int nb, int row_stride,
                             void* stream, int* plan) {
  if (ks != KS || nb != NB || row_stride != NBP || n_tiles < 1 ||
      reinterpret_cast<uintptr_t>(slabs) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  using bf16 = __nv_bfloat16;
  const msv::Prepared<bf16> ops{static_cast<const bf16*>(slabs),
                                static_cast<const bf16*>(tail),
                                static_cast<const bf16*>(wts), bands, woff,
                                tile_bands, n_tiles, n_wts};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  msv::Plan* pl = reinterpret_cast<msv::Plan*>(plan);
  *pl = {};
  if (wave_is_i16) {
    return launch<int16_t>(wave, wave_stride, wave_len, batch, ops, out, win,
                           hop, n_frames, n_freq, n_mel, pl, st);
  }
  return launch<float>(wave, wave_stride, wave_len, batch, ops, out, win, hop,
                       n_frames, n_freq, n_mel, pl, st);
}

}  // extern "C"
