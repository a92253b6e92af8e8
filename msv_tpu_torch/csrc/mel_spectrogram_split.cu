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
// on paper.  Every block of 64 frames also reads all four planes of C/S
// from L2 (15.7 MB at 48 kHz, 376 blocks: 5.9 GB a launch): the bulk copies
// alone take about 0.75 ms of a launch, the floor under this tiling.
// Measured on an H100 80GB HBM3 at 700 W (kernels/probe.py, 48 kHz, B = 1):
// 1.6 ms.  The wgmma run at about the bf16 peak rate while they run (0.57
// to 0.65 ms in all), but with two warps a scheduler their time adds to
// the warps' own work between two groups (waits, the FADD of each slab's
// sums, the ring: 0.4 ms), the ring's waits on L2 (0.2 ms) and the mel
// pass (0.2 ms) instead of hiding it.  The earlier design (each 32-row slab fetched with
// 2-byte loads between two barriers, mma.sync, a whole K sweep for the one
// bin of the last tile, the filterbank read from global memory and a dB
// pass over the output) took 5.5 ms, 10% of the bound.
//
// What the design does about it:
//  * Ch, Cl, Sh, Sl arrive through mel_common.cuh's ring: prepare_operands
//    (mode="split") lays them out as slabs of KS = 16 rows x NB = 128 bins,
//    four planes each cut into 8 x 8 core matrices of 128 contiguous bytes
//    (a plane is [2 row groups][16 bin groups][8 rows][8 bins]): the image
//    a wgmma shared-memory descriptor reads without swizzle (bins
//    contiguous: the transposed B), 16 KB a slab, one bulk copy per slab, at
//    least three in flight.  A ninth warp is the producer: it refills a
//    stage as soon as all 8 consumer warps have arrived on its `empty`
//    mbarrier.
//  * The products are wgmma.mma_async m64n128k16 (bf16 in, f32 out): the 8
//    consumer warps are two warpgroups, one computing re (planes Ch, Cl),
//    the other im (Sh, Sl), each for all 64 frames and the tile's 128 bins
//    in 64 accumulator registers.  A (the frames' hi, then lo, fragments)
//    comes from registers; B (a plane of the stage) from shared memory by
//    descriptor.  A slab's three wgmma are one commit group; while it runs
//    the warps load the next slab's A fragment (double-buffered
//    registers), and the stage is released when wait_group has seen the
//    group complete.  Nine warps leave 168 registers a thread (three of
//    them share one of the SM's four 16K-register partitions); the kernel
//    fits them (8 bytes of spill) without setmaxnreg.
//  * What the warps do between two wgmma groups sets the pace, so the
//    loop does little: the samples are split once, as the block stages
//    them (the first wgmma form split every A fragment from f32 samples in
//    the loop and took 1.9 ms): a hi and a lo bf16 copy in overlapping rows
//    (row r holds the samples from r*hop on, hop + 16 of them, at a row
//    stride of 8 mod 16 elements, so the A-fragment loads of frames g =
//    0..7 hit 32 banks; frame f's samples n0..n0+15 sit in row f + n0/hop:
//    one offset for the warp, any hop).  An A register is two 32-bit loads
//    and a funnel shift by 0 or 16 bits (odd hops give odd offsets), with
//    no branch; the descriptors move by one add.  Forms that keep a second
//    group in flight while the sums are added (two groups a slab, two sets
//    of sums) were tried: ptxas serialises them (C7514, C7518) and they
//    came out slower.
//  * The tensor cores' f32 accumulation does not round to nearest, so each
//    slab's three products accumulate in fresh registers (scale-d = 0 on
//    the first) and are added to the running sums by f32 FADD, as in the
//    parity kernel; small terms (hi.lo, lo.hi) go first.
//  * One block per (tile of TF = 16*MT frames, batch row); MT = 4 where the
//    samples fit, else 2 or 1 (long windows): a warp whose 16 frames lie
//    past TF feeds zeros, so the one wgmma shape serves all.
//  * At a tile's end the warpgroups swap halves through shared memory (the
//    im of bins 0..63 one way, the re of bins 64..127 the other; thread to
//    thread, as both hold the same fragment layout), and each writes the
//    magnitudes of its 64 bins, split into a packed (hi, lo) pair.  Tiles
//    cover n_freq - 1 = n_fft/2 bins; the last one adds the leftover bin
//    n_freq - 1 with SIMT FMAs in split form over its kept columns as one
//    more magnitude column.  No launch walks K for a tile of one bin.
//  * The magnitude tile has its own shared memory (the ring is being
//    refilled for the next tile meanwhile); the mel product is
//    mel_common.cuh's mel_tile in split form: band tables and the compact
//    weights as packed (hi, lo) pairs in shared memory, lanes over bands (a
//    warp's stores are 128 contiguous bytes), one owner thread per (frame,
//    band) adding bins in increasing order (no atomics: deterministic), dB
//    written by the tile that ends a band.
//
// MSV_SPLIT_WGMMA=0 builds the same kernel with mma.sync.m16n8k16 products
// (ldmatrix reads the same core matrices; each warp 16 bins of the tile and
// all frames, re and im), which kernels/probe.py times beside it.

#include "mel_common.cuh"

#ifndef MSV_SPLIT_WGMMA
#define MSV_SPLIT_WGMMA 1
#endif

namespace {

using msv::WARPS;
using bf16 = __nv_bfloat16;
constexpr bool kWgmma = MSV_SPLIT_WGMMA;
// each slab's products summed apart and added by FADD (wgmma form)
constexpr bool kStageFadd = true;
constexpr int KS = msv::kSlabRows;  // C/S rows per slab: one k16 step
constexpr int NB = 128;             // bins per frequency tile: the wgmma's n
constexpr int WCOLS = NB / WARPS;   // bins per warp, mma.sync form
constexpr int CORE = 8;             // a core matrix: 8 rows x 8 bins, 128 B
constexpr int CORE_BYTES = CORE * CORE * sizeof(bf16);
constexpr int KG_BYTES = NB / CORE * CORE_BYTES;  // one group of 8 rows
constexpr int PLANE_BYTES = KS / CORE * KG_BYTES;  // Ch, Cl, Sh or Sl
constexpr uint32_t SLAB_BYTES = 4 * PLANE_BYTES;
constexpr int STAGE_LOADS = 16;  // sample loads in flight per thread
static_assert(KS == 16, "one k16 step per slab");
static_assert(SLAB_BYTES % 16 == 0, "bulk copies move 16-byte multiples");
enum Plane { CH = 0, CL = 1, SH = 2, SL = 3 };

// The shared-memory descriptor of a 16 x 128 B operand (a plane of a
// stage), bins contiguous, no swizzle: core matrices along the bins
// CORE_BYTES apart (the stride byte offset, the high word), the two groups
// of 8 rows KG_BYTES apart (the leading byte offset), all in 16-byte units.
// The low word holds the address, so a descriptor moves by adding bytes / 16
// to it (shared memory ends below 2^18).
__device__ __forceinline__ uint32_t b_desc_lo(uint32_t addr) {
  return ((addr & 0x3FFFF) >> 4) | ((KG_BYTES >> 4) << 16);
}

__device__ __forceinline__ uint64_t b_desc(uint32_t lo) {
  return (static_cast<uint64_t>(CORE_BYTES >> 4) << 32) | lo;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N of this warpgroup's commit groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 frames x 128 bins, this thread's 64 values) = a . B + (keep ? d : 0)
// on the tensor cores, asynchronously: a the thread's registers of the 64 x
// 16 bf16 A fragment (the mma.sync m16n8k16 layout, warp w rows 16w on), B
// 16 x 128 bf16 in shared memory by descriptor, bins contiguous (trans-b).
// d[4*j + q] is bin 8*j + 2*tig + (q & 1) of frame 16*w + g + 8*(q >> 1).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc, int keep) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(keep));
}

// d = xh.Bl + xl.Bh + xh.Bh (+ d if keep), small terms first: the three
// products of one split-f32 product as one commit group, B's hi and lo
// planes by their descriptors' low words.
__device__ __forceinline__ void products(float (&d)[64],
                                         const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4],
                                         uint32_t b_hi, uint32_t b_lo,
                                         int keep) {
  wgmma_fence();
  wgmma_m64n128k16(d, ah, b_desc(b_lo), keep);
  wgmma_m64n128k16(d, al, b_desc(b_hi), 1);
  wgmma_m64n128k16(d, ah, b_desc(b_hi), 1);
  wgmma_commit();
}

// Keep the compiler from reading a wgmma's sums before its wait_group.
__device__ __forceinline__ void settle(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
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

// Slabs per frequency tile: the window's rows in slabs of KS, an even
// number of them (prepare_operands pads with zero rows), so that the slab
// loop runs in pairs.
__host__ __device__ constexpr int slabs_per_tile(int win) {
  return (win + 2 * KS - 1) / (2 * KS) * 2;
}

// Words of the magnitude tile, [NB + 1][tf + 1], rounded up to 4.
__host__ __device__ constexpr int mag_elems(int tf) {
  return ((NB + 1) * (tf + 1) + 3) / 4 * 4;
}

// Where the band tables start: after the mbarriers, the ring, the
// magnitude tile (NB + 1 bins) and the staged sample rows (through frame
// TF-1's window rounded up to whole slabs; a hi and a lo copy), at a
// 16-byte boundary.
__host__ __device__ __forceinline__ size_t tables_offset(int mt, int win,
                                                         int hop,
                                                         int stages) {
  const int tf = 16 * mt;
  const int win_p = slabs_per_tile(win) * KS;
  const size_t rows = tf + (win_p - 1) / hop;
  const size_t end = msv::kRingOffset + stages * SLAB_BYTES +
                     sizeof(uint32_t) * mag_elems(tf) +
                     2 * sizeof(bf16) * rows * sample_stride(hop);
  return (end + 15) / 16 * 16;
}

// The two samples at p and p + 1 as one A register, p an element `odd` (0
// or 1) past a word boundary: the aligned word, or the halves of two, with
// no branch (a branch around registers that a wgmma in flight may read
// makes ptxas serialise the products).
__device__ __forceinline__ uint32_t pair_at(const bf16* p, int odd) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(p - odd);
  return __funnelshift_r(w[0], w[1], 16 * odd);
}

// The A registers of one m16k16 fragment: frames at element offsets r0 and
// r1 (rows g and g + 8), columns 2*tig.. of a k-step starting at `x`;
// zeros unless `live`.
__device__ __forceinline__ void load_a(const bf16* x, int r0, int r1, int odd,
                                       bool live, uint32_t (&a)[4]) {
  a[0] = live ? pair_at(x + r0, odd) : 0u;
  a[1] = live ? pair_at(x + r1, odd) : 0u;
  a[2] = live ? pair_at(x + r0 + 8, odd) : 0u;
  a[3] = live ? pair_at(x + r1 + 8, odd) : 0u;
}

// (re, im) of the leftover bin for frame tid / P of the block's TF frames,
// as mel_common.cuh's leftover_bin, in split form: the staged samples are
// the hi and lo copies, `tail` row n holds (Ch, Cl), (Sh, Sl) of bin
// n_freq - 1 as two bf16 pairs, and each product is xh*tl + xl*th + xh*th
// (bf16 products are exact in f32).
template <int TF>
__device__ __forceinline__ float2 leftover_bin_split(
    const bf16* hi, const bf16* lo, int hs, int hop,
    const uint2* __restrict__ tail, int win, int tid) {
  constexpr int P = 32 * WARPS / TF;
  static_assert(P >= 1 && P <= 32 && (P & (P - 1)) == 0, "P: 1 to 32");
  const int f = tid / P, p = tid % P;
  float re = 0.0f, im = 0.0f;
  for (int r = 0, n0 = 0; n0 < win; ++r, n0 += hop) {
    const long long row = static_cast<long long>(f + r) * hs - n0;
    const int end = min(win, n0 + hop);
#pragma unroll 4
    for (int n = n0 + ((p - n0) % P + P) % P; n < end; n += P) {
      const float xh = __bfloat162float(hi[row + n]);
      const float xl = __bfloat162float(lo[row + n]);
      const uint2 t = tail[n];
      const float2 c = msv::split_unpack(t.x), s = msv::split_unpack(t.y);
      re = fmaf(xh, c.y, re);  // small terms first
      re = fmaf(xl, c.x, re);
      re = fmaf(xh, c.x, re);
      im = fmaf(xh, s.y, im);
      im = fmaf(xl, s.x, im);
      im = fmaf(xh, s.x, im);
    }
  }
#pragma unroll
  for (int o = P / 2; o > 0; o /= 2) {
    re += __shfl_xor_sync(0xffffffffu, re, o);
    im += __shfl_xor_sync(0xffffffffu, im, o);
  }
  return make_float2(re, im);
}

// MT m-tiles of 16 frames per block.
template <typename T, int MT>
__global__ void __launch_bounds__(32 * (WARPS + 1), 1)
mel_db_split_kernel(const T* __restrict__ wave, long long wave_stride,
                    long long wave_len, const msv::Prepared<uint32_t> ops,
                    float* __restrict__ out, int win, int hop, int n_frames,
                    int n_freq, int n_mel, int stages) {
  constexpr int TF = 16 * MT;
  constexpr int P = 32 * WARPS / TF;  // threads per frame, leftover bin
  extern __shared__ __align__(128) unsigned char smem[];
  const int n_k = slabs_per_tile(win);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  const msv::Ring ring{bars, bars + msv::kMaxStages, smem + msv::kRingOffset,
                       reinterpret_cast<const unsigned char*>(ops.slabs),
                       SLAB_BYTES, stages, ops.n_tiles * n_k};
  constexpr int MS = msv::mag_stride<TF, uint32_t>();
  static_assert(MS == TF + 1, "mag_elems counts TF + 1 words a bin");
  // [NB + 1][MS] packed (hi, lo) magnitudes; at a tile's end first the
  // halves the warpgroups swap
  uint32_t* mag = reinterpret_cast<uint32_t*>(smem + msv::kRingOffset +
                                              stages * SLAB_BYTES);
  constexpr int LT = 32 * MT;  // threads of a warpgroup that hold frames
  static_assert(mag_elems(TF) >= 2 * 32 * LT,
                "the swapped halves fit the magnitude tile");
  const int rl = row_len(hop), hs = sample_stride(hop);
  const int rows = TF + (n_k * KS - 1) / hop;
  bf16* chunk_hi = reinterpret_cast<bf16*>(mag + mag_elems(TF));
  bf16* chunk_lo = chunk_hi + rows * hs;  // overlapping rows at stride hs
  unsigned char* tables = smem + tables_offset(MT, win, hop, stages);

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * 32 + lane;
  const int g = lane >> 2;   // fragment row / B column
  const int tig = lane & 3;  // fragment column pair
  const int f0 = blockIdx.x * TF;
  const T* w = wave + static_cast<long long>(blockIdx.y) * wave_stride;
  const long long base = static_cast<long long>(f0) * hop;

  ring.start(tid);
  // the consumer warps stage the samples, split: row r holds samples r*hop on
  for (int r = warp; r < rows && warp < WARPS; r += WARPS) {
    const long long g0 = base + static_cast<long long>(r) * hop;
    for (int cb = 0; cb < rl; cb += 32 * STAGE_LOADS) {
      float v[STAGE_LOADS];  // all loads in flight before the stores
#pragma unroll
      for (int u = 0; u < STAGE_LOADS; ++u) {
        const int c = cb + lane + 32 * u;
        v[u] = c < rl && g0 + c < wave_len ? msv::load_sample(w, g0 + c)
                                           : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < STAGE_LOADS; ++u) {
        const int c = cb + lane + 32 * u;
        if (c < rl) {
          const bf16 h = __float2bfloat16_rn(v[u]);
          chunk_hi[r * hs + c] = h;
          chunk_lo[r * hs + c] =
              __float2bfloat16_rn(v[u] - __bfloat162float(h));
        }
      }
    }
  }
  const msv::BandTables<uint32_t> tb =
      msv::stage_tables(tables, ops, n_mel, tid);
  __syncthreads();
  if (warp == msv::kProducer) {  // the producer warp keeps the ring full
    ring.produce(lane);
    return;
  }

  float* o = out + (static_cast<long long>(blockIdx.y) * n_frames + f0) * n_mel;
  const int nf = min(TF, n_frames - f0);
  msv::Ring::Cursor cur;

  // wgmma form: warpgroup 0 computes re, warpgroup 1 im; its warp wq holds
  // frames 16*wq + g and + 8 (zeros past TF)
  const int wg = warp >> 2, wq = warp & 3;
  [[maybe_unused]] const bool live = wq < MT;
  // this thread's A rows, column 2*tig
  // (a warp past TF reads the first frames and feeds zeros)
  [[maybe_unused]] const int a0 = (live ? 16 * wq + g : g) * hs + 2 * tig,
                             a1 = a0 + 8 * hs;
  // the descriptor's low word of stage 0: plane Ch, or Sh for warpgroup 1
  [[maybe_unused]] const uint32_t desc0 =
      b_desc_lo(msv::smem_u32(ring.stage0) + wg * SH * PLANE_BYTES);
  // mma.sync form: this warp's first bin in the tile, and the B rows and
  // bins this lane addresses for ldmatrix
  [[maybe_unused]] const int wn0 = warp * WCOLS;
  const int brow = (lane & 7) + ((lane >> 3) & 1) * 8;
  [[maybe_unused]] const int boff =
      (brow >> 3) * KG_BYTES + (brow & 7) * (CORE * 2) +
      ((wn0 >> 3) + (lane >> 4)) * CORE_BYTES;

  // a slab's KS samples on: whole rows and columns (wgmma form)
  [[maybe_unused]] const int step_roff = KS / hop * hs, step_cols = KS % hop;

  for (int t = 0; t < ops.n_tiles; ++t) {
    const int k0 = t * NB;
    const int nv = min(NB, n_freq - 1 - k0);
    // the k-step's samples n0..n0+15 of every frame: row offset j (as
    // roff) and column c0 = n0 - j*hop; uniform across the warp
    int roff = 0, c0 = 0;

    if constexpr (kWgmma) {
      // This warpgroup's sums (re or im) of the tile's 128 bins (acc) and
      // one slab's (pre).  A slab's three wgmma are one
      // commit group; while it runs the warps load the next slab's A
      // fragment into the other pair of registers, then they wait and add.
      // The slabs of a tile are an even number, so the loop runs in pairs
      // over the two pairs of A registers.
      float acc[64], pre[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = pre[i] = 0.0f;
      float(&d)[64] = kStageFadd ? pre : acc;
      uint32_t ah0[4] = {0, 0, 0, 0}, al0[4] = {0, 0, 0, 0};
      uint32_t ah1[4] = {0, 0, 0, 0}, al1[4] = {0, 0, 0, 0};
      // the A fragment of the slab at (roff, c0), and on to the next slab;
      // past the tile's last slab (`more` false) the first slab's again,
      // which is not used
      auto load_next = [&](uint32_t(&ah)[4], uint32_t(&al)[4], bool more) {
        const int at = more ? roff + c0 : 0, odd = more ? c0 & 1 : 0;
        load_a(chunk_hi + at, a0, a1, odd, live, ah);
        load_a(chunk_lo + at, a0, a1, odd, live, al);
        c0 += step_cols;
        const bool wrap = c0 >= hop;  // one more row
        c0 -= wrap ? hop : 0;
        roff += wrap ? step_roff + hs : step_roff;
      };
      // slab j with its fragment in (ah, al); (nh, nl) takes slab j + 1's
      auto slab = [&](int j, const uint32_t(&ah)[4], const uint32_t(&al)[4],
                      uint32_t(&nh)[4], uint32_t(&nl)[4]) {
        const uint32_t bs = desc0 + cur.s * (SLAB_BYTES >> 4);
        ring.acquire(cur);
        products(d, ah, al, bs, bs + (PLANE_BYTES >> 4),
                 kStageFadd ? 0 : j > 0);
        load_next(nh, nl, j + 1 < n_k);
        wgmma_wait<0>();
        settle(d);
        ring.release(cur, lane);
        if constexpr (kStageFadd) {
#pragma unroll
          for (int i = 0; i < 64; ++i) acc[i] += pre[i];
        }
      };
      load_next(ah0, al0, true);
      for (int j = 0; j < n_k; j += 2) {
        slab(j, ah0, al0, ah1, al1);
        slab(j + 1, ah1, al1, ah0, al0);
      }
      // every warp is done with the last tile's mel pass and these slabs
      msv::consumer_sync();
      // the warpgroups swap halves, thread to thread (value i of thread
      // tid % 128 at word i * LT + tid % 128): im of bins 0..63 to
      // warpgroup 0, re of bins 64..127 to warpgroup 1
      uint32_t* mine = mag + wg * (32 * LT) + (tid & 127);
      const uint32_t* theirs = mag + (1 - wg) * (32 * LT) + (tid & 127);
      if (live) {
#pragma unroll
        for (int i = 0; i < 32; ++i)
          mine[i * LT] = __float_as_uint(wg ? acc[i] : acc[32 + i]);
      }
      msv::consumer_sync();
      float m[32];  // |X| of this warpgroup's 64 bins
      if (live) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const float x = wg ? acc[32 + i] : acc[i];
          const float y = __uint_as_float(theirs[i * LT]);
          m[i] = sqrtf(x * x + y * y);
        }
      }
      msv::consumer_sync();
      // packed (hi, lo) into mag[bin][frame], for the bins the products
      // cover
      if (live) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = wg * 64 + (i >> 2) * 8 + tig * 2 + (i & 1);
          if (col < nv)
            mag[col * MS + 16 * wq + g + ((i >> 1) & 1) * 8] =
                msv::split_pack(m[i]);
        }
      }
    } else {
      float re[MT][2][4], im[MT][2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) re[mt][nt][q] = im[mt][nt][q] = 0.0f;
      for (int j = 0; j < n_k; ++j) {
        const unsigned char* cs = ring.acquire(cur);
        // B fragments of the warp's 2 n-tiles, per plane
        uint32_t b[4][4];
#pragma unroll
        for (int p = 0; p < 4; ++p)
          msv::ldmatrix_x4_trans(b[p], reinterpret_cast<const bf16*>(
                                           cs + p * PLANE_BYTES + boff));
        ring.release(cur, lane);
        const int ar = g * hs + 2 * tig;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t ah[4], al[4];
          const int r0 = ar + 16 * mt * hs, r1 = r0 + 8 * hs;
          load_a(chunk_hi + roff + c0, r0, r1, c0 & 1, true, ah);
          load_a(chunk_lo + roff + c0, r0, r1, c0 & 1, true, al);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int h = nt * 2;
            msv::mma_bf16(re[mt][nt], ah, b[CL][h], b[CL][h + 1]);
            msv::mma_bf16(re[mt][nt], al, b[CH][h], b[CH][h + 1]);
            msv::mma_bf16(re[mt][nt], ah, b[CH][h], b[CH][h + 1]);
            msv::mma_bf16(im[mt][nt], ah, b[SL][h], b[SL][h + 1]);
            msv::mma_bf16(im[mt][nt], al, b[SH][h], b[SH][h + 1]);
            msv::mma_bf16(im[mt][nt], ah, b[SH][h], b[SH][h + 1]);
          }
        }
        c0 += KS;
        while (c0 >= hop) {
          c0 -= hop;
          roff += hs;
        }
      }
      msv::consumer_sync();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int col = wn0 + nt * 8 + tig * 2 + (q & 1);
            if (col < nv) {
              const float x = re[mt][nt][q], y = im[mt][nt][q];
              mag[col * MS + mt * 16 + g + (q >> 1) * 8] =
                  msv::split_pack(sqrtf(x * x + y * y));
            }
          }
    }

    int kt = NB;
    if (t == ops.n_tiles - 1) {  // the leftover bin n_freq - 1, column nv
      const uint2* tl = reinterpret_cast<const uint2*>(msv::stage_tail(
          smem + msv::kRingOffset, stages * SLAB_BYTES, ops.tail, win, tid));
      msv::consumer_sync();
      const float2 v = leftover_bin_split<TF>(chunk_hi, chunk_lo, hs, hop, tl,
                                              win, tid);
      if (tid % P == 0)
        mag[nv * MS + tid / P] =
            msv::split_pack(sqrtf(v.x * v.x + v.y * v.y));
      kt = nv + 1;
    }
    msv::consumer_sync();

    msv::mel_tile<TF, true>(mag, tb, __ldg(ops.tile_bands + 2 * t),
                            __ldg(ops.tile_bands + 2 * t + 1), o, k0, kt,
                            n_mel, nf, lane, warp);
  }
  msv::mel_empty_bands<TF>(o, tb.bands, n_mel, nf, lane, warp);
}

// Shared memory besides the ring.
size_t fixed_bytes(int mt, int win, int hop, int n_mel, int n_wts) {
  return tables_offset(mt, win, hop, 0) +
         msv::table_bytes(n_mel, n_wts, sizeof(uint32_t));
}

template <typename T, int MT>
int launch_mt(const void* wave, long long wave_stride, long long wave_len,
              int batch, const msv::Prepared<uint32_t>& ops, float* out,
              int win, int hop, int n_frames, int n_freq, int n_mel,
              int stages, msv::Plan* plan, cudaStream_t stream) {
  const size_t smem =
      fixed_bytes(MT, win, hop, n_mel, ops.n_wts) + stages * SLAB_BYTES;
  *plan = {msv::kResident, MT, stages, 0, static_cast<int>(smem),
           plan->avail};
  cudaError_t err = cudaFuncSetAttribute(
      mel_db_split_kernel<T, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_frames + 16 * MT - 1) / (16 * MT), batch);
  const dim3 block(32, WARPS + 1);  // and the producer warp
  mel_db_split_kernel<T, MT><<<grid, block, smem, stream>>>(
      static_cast<const T*>(wave), wave_stride, wave_len, ops, out, win, hop,
      n_frames, n_freq, n_mel, stages);
  return static_cast<int>(cudaGetLastError());
}

// The most m-tiles (4, 2, then 1) whose block fits with a ring of three
// stages: more frames per block means fewer slab copies per frame.  It has
// no chunked tier: where none fits (windows of 7056 samples and more, 176.4
// kHz and up at the session's settings) nothing is launched.
template <typename T>
int launch(const void* wave, long long wave_stride, long long wave_len,
           int batch, const msv::Prepared<uint32_t>& ops, float* out, int win,
           int hop, int n_frames, int n_freq, int n_mel, msv::Plan* plan,
           cudaStream_t stream) {
  msv::SmemLimits lim;
  if (const int err = msv::smem_limits(&lim)) return err;
  plan->avail = static_cast<int>(lim.block);
#define MSV_LAUNCH(M)                                                        \
  if (const int st = msv::ring_stages(                                     \
          fixed_bytes(M, win, hop, n_mel, ops.n_wts), SLAB_BYTES, lim))     \
    return launch_mt<T, M>(wave, wave_stride, wave_len, batch, ops, out,    \
                           win, hop, n_frames, n_freq, n_mel, st, plan,    \
                           stream);
  MSV_LAUNCH(4)
  MSV_LAUNCH(2)
  MSV_LAUNCH(1)
#undef MSV_LAUNCH
  plan->smem = static_cast<int>(fixed_bytes(1, win, hop, n_mel, ops.n_wts) +
                                3 * SLAB_BYTES);
  return static_cast<int>(cudaErrorInvalidConfiguration);
}

}  // namespace

extern "C" {

// The arguments of msv_mel_spectrogram, with the prepared record of split
// mode (bf16): slabs of ks rows x nb bins as four planes (Ch, Cl, Sh, Sl)
// of 8 x 8 core matrices (`core` = 8 must be this kernel's CORE, ks and nb
// its KS and NB); tail: (win, 4), the columns of bin n_freq - 1 of Ch, Cl,
// Sh, Sl; wts: (n_wts, 2), each band's weights over its bins as (hi, lo)
// pairs; plan as msv_mel_spectrogram's.  Launches on `stream` without
// synchronising; returns the launch's cudaError_t.
int msv_mel_spectrogram_split(const void* wave, int wave_is_i16,
                              long long wave_stride, long long wave_len,
                              int batch, const void* slabs, const void* tail,
                              const void* wts, const int* bands,
                              const int* woff, const int* tile_bands,
                              float* out, int win, int hop, int n_frames,
                              int n_freq, int n_mel, int n_tiles, int n_wts,
                              int ks, int nb, int core, void* stream,
                              int* plan) {
  if (ks != KS || nb != NB || core != CORE || n_tiles < 1 ||
      reinterpret_cast<uintptr_t>(slabs) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(tail) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(wts) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const msv::Prepared<uint32_t> ops{static_cast<const uint32_t*>(slabs),
                                    static_cast<const uint32_t*>(tail),
                                    static_cast<const uint32_t*>(wts), bands,
                                    woff, tile_bands, n_tiles, n_wts};
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
