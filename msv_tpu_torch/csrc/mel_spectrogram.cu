// Fused mel dB spectrogram for Hopper (sm_90a), f32 parity mode.
//
// Replaces the TPU kernel msv_tpu/kernels/spectrogram_pallas.py::
// mel_spectrogram_pallas (both schedules, `resident` and `stream`, in f32
// operand mode, precision=HIGHEST).  One launch computes, for every frame k
// of every batch row,
//
//   frame = padded[k*hop : k*hop + win]        (int16 input scaled by 2^-15)
//   re = frame . C,  im = frame . S            (C, S: (win, n_freq) f32)
//   mel = sqrt(re^2 + im^2) . fb               (fb: (n_freq, n_mel) f32)
//   dB  = 20*ln(mel)/ln(10) if mel > 1e-18 else -360
//
// The DFT pair runs on the tensor cores in 3xTF32, as the TPU reference
// gets f32 from its MXU by several passes (precision=HIGHEST): each f32
// value x is split in registers into hi = tf32_rna(x) and lo = tf32_rna(x -
// hi), and each product x*c is taken as xh*ch + xl*ch + xh*cl with
// mma.sync.m16n8k8 (tf32 in, f32 accumulate).  The products of 11-bit
// significands are exact in f32; the dropped xl*cl and the rounding of lo
// leave about 2^-21 of each product, a few units of f32 roundoff.  The
// tensor cores' f32 accumulation does not round to nearest: summed over a
// whole window (720 k-steps at 120 ms) it moved a one-bin band of white
// noise 0.04 dB from an f64 witness.  So each slab's 16 samples accumulate
// in fresh registers, added to the running sums by f32 FADD (round to
// nearest) once per slab.  A 16-bit sample splits exactly: the int16 route
// is bit-equal to the f32 route.  The magnitude, the mel product and the dB
// stay SIMT f32.
//
// What bounds it on an H100: the tensor cores.  The DFT pair is 2*2*win*
// (n_freq - 1) FLOPs a frame issued three times: 566 GFLOP at 48 kHz for
// 240 s (24 001 frames), 1.15 ms at the 495 TFLOP/s dense TF32 peak; HBM
// traffic (the wave once, the dB plane once, about 0.05 GB) is 0.02 ms.
// Every block also reads all of the C/S slabs from L2: 15.7 MB in f32 at
// 48 kHz, 376 blocks, about 5.9 GB.  Measured on an H100 80GB HBM3 at 700 W
// (kernels/probe.py, 48 kHz, B = 1): 4.1 ms, of which the products alone
// take 3.5 ms, the slab ring adds 0.6 ms and the SIMT parts (staging, the
// leftover bin, the mel pass) 0.4 ms.  A third of the mma takes 60% of the
// time: mma.sync m16n8k8 in TF32 issues at about 37% of the TF32 peak here,
// and that rate, not the ring or L2, is the limit.  The levers are wgmma
// (asynchronous, the full rate; C/S as hi/lo planes in shared memory) and
// then a two-block cluster sharing each slab by multicast copies.
//
// What the design does about it:
//  * One block per (tile of TF = 16*MT frames, batch row), 8 warps.  Each
//    warp owns all TF frames and 16 of the NB = 128 bins of the current
//    frequency tile: every B fragment it splits feeds MT m-tiles, every A
//    fragment 2 n-tiles x 2 matrices, 12*MT independent mma per 8 samples
//    of K.
//  * C and S arrive through mel_common.cuh's ring: prepare_operands lays
//    them out as slabs of KS = 16 rows x NB bins (C rows then S rows at a
//    row stride of NB + 8 = 136 floats, 8 mod 32 words: the B-fragment reads
//    at rows tig and tig + 4, column g, hit 32 banks), one bulk copy per
//    slab, at least three in flight; the copy of slab j + 2 overlaps the
//    products of slab j, and thread 0 refills a stage after the barrier
//    that follows its last read (a producer warp would cut the registers
//    to 168 a thread: mel_common.cuh).  B fragments are split in registers
//    as they are read, so the ring moves half the bytes of hi/lo planes.
//  * The block stages its samples once, in f32, in overlapping rows: row r
//    holds the R = ceil8(hop) + 8 samples from r*hop on, at a row stride
//    hs = R + 4 (4 mod 8 words).  Frame f's samples n0..n0+7 of a k-step
//    sit in row f + j, j = n0/hop, columns n0 - j*hop on: one offset for
//    the whole warp, any hop (odd ones included) and any frame start, and
//    the A-fragment reads of frames g = 0..7 at columns tig = 0..3 hit 32
//    banks.  Device memory sees the wave once, not win/hop times.
//  * Tiles cover n_freq - 1 = n_fft/2 bins; the last one adds the leftover
//    bin n_freq - 1 with SIMT f32 FMAs over its kept columns (2*win FMAs a
//    frame, 0.1% of the work) as one more magnitude column.  No launch walks
//    K for a tile of one bin.
//  * The mel product reads only each band's nonzero bins, from the compact
//    filterbank of prepare_operands (mel_common.cuh's mel_tile), one owner
//    thread per (frame, band) adding bins in increasing order: no atomics,
//    deterministic, int16 bit-equal to f32.  A band's sum is written as dB
//    in the tile that holds its last bin.
//  * MT (4, 2, then 1) is the largest whose samples, magnitude tile and
//    three ring stages fit the card's shared memory; the ring then deepens
//    while as many blocks still fit on an SM.
//
// The chunked tier (mel_db_tf32_chunked_kernel), for windows whose samples
// no block holds: 16*MT*hop + win floats with the band tables (12*n_mel +
// 4*n_wts bytes) beside them pass the 227 KB a block may use at every MT
// from 176.4 kHz on at the session's settings (windows of 7056 samples;
// 384 kHz needs 415 KB at MT 1).  Its shared memory is bounded whatever
// the window: the ring, the magnitude tile and one chunk of kc samples for
// each of the TF frames, 4 B * TF * (kc + 4); the band tables and the
// leftover bin's kept columns are read from device memory.  The launcher
// takes it where no resident MT fits, with one plan whatever the shape
// (CHUNK_MT and CHUNK): MT 4, kc 512, 212.9 KB with three stages, the most
// m-tiles and then the longest power-of-two chunk that fit an H100's
// block.  The chunks are staged again for every frequency tile (64
// tiles at n_fft 16 384): device memory sees the wave n_tiles times, at
// the HBM rate about 1% of the products' time.  Measured (kernels/probe.py,
// NVIDIA H100 80GB HBM3 at 700 W, B = 1, f32 input, 6001 frames of 60 s):
// 78.3 ms at 384 kHz, 38.6 TFLOP/s of the f32 DFT pair (48 kHz resident:
// 33.7); forced on where the resident tier fits, 1.34 ms at 48 kHz against
// its 1.40, and 4.73 ms at 88.2 kHz against 5.77 (resident MT 2).

#include "mel_common.cuh"

namespace {

using msv::WARPS;
constexpr int KS = msv::kSlabRows;  // C/S rows per slab
constexpr int WCOLS = 16;           // bins per warp: 2 n-tiles of 8
constexpr int NB = WARPS * WCOLS;   // bins per frequency tile
constexpr int ROW = NB + 8;         // slab row stride (floats)
constexpr int SLAB = 2 * KS * ROW;  // floats per slab: C rows, then S rows
constexpr uint32_t SLAB_BYTES = SLAB * sizeof(float);
constexpr int STAGE_LOADS = 16;     // sample loads in flight per thread
constexpr int CHUNK_MT = 4;         // the chunked tier's m-tiles
constexpr int CHUNK = 512;          // and its samples a frame a chunk
static_assert(SLAB_BYTES % 16 == 0, "bulk copies move 16-byte multiples");

// (hi, lo) of x as tf32 register values: hi = tf32_rna(x), lo =
// tf32_rna(x - hi); x - hi is exact in f32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// d += a . b on the tensor cores: one m16n8k8 tile, tf32 in, f32
// accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One k-step of 8 samples into this slab's products `part`: the B
// fragments of the warp's 2 n-tiles of C and S (slab rows kk + tig and
// kk + tig + 4, column g of each n-tile) times the A fragments of its MT
// m-tiles (frame rows at arow, samples from x on), each product in 3xTF32.
template <int MT>
__device__ __forceinline__ void kstep(float (&part)[2][MT][2][4],
                                      const float* cs, int kk, const float* x,
                                      const int (&arow)[MT][2], int wn0,
                                      int g, int tig) {
  uint32_t bh[2][2][2], bl[2][2][2];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        split_tf32(cs[m * KS * ROW + (kk + tig + 4 * r) * ROW + wn0 +
                      nt * 8 + g],
                   bh[m][nt][r], bl[m][nt][r]);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    uint32_t ah[4], al[4];
    split_tf32(x[arow[mt][0]], ah[0], al[0]);
    split_tf32(x[arow[mt][1]], ah[1], al[1]);
    split_tf32(x[arow[mt][0] + 4], ah[2], al[2]);
    split_tf32(x[arow[mt][1] + 4], ah[3], al[3]);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {  // small terms first
        mma_tf32(part[m][mt][nt], al, bh[m][nt]);
        mma_tf32(part[m][mt][nt], ah, bl[m][nt]);
        mma_tf32(part[m][mt][nt], ah, bh[m][nt]);
      }
  }
}

// |X| in f32 into mag[bin][frame] for the bins [0, nv) of the tile that
// this warp's products cover.
template <int MT>
__device__ __forceinline__ void store_magnitude(
    float* mag, const float (&acc)[2][MT][2][4], int nv, int wn0, int g,
    int tig) {
  constexpr int MS = msv::mag_stride<16 * MT, float>();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = wn0 + nt * 8 + tig * 2 + (q & 1);
        if (col < nv) {
          const float x = acc[0][mt][nt][q], y = acc[1][mt][nt][q];
          mag[col * MS + mt * 16 + g + (q >> 1) * 8] = sqrtf(x * x + y * y);
        }
      }
}

// Samples per staged row: hop, rounded up to 8, and the 8 a k-step reads
// past a row's own hop samples.
__host__ __device__ __forceinline__ int row_len(int hop) {
  return (hop + 7) / 8 * 8 + 8;
}

// Row stride of the staged samples: 4 mod 8 words, so that 8 frames' rows
// start in 8 distinct 4-bank groups.
__host__ __device__ __forceinline__ int sample_stride(int hop) {
  return row_len(hop) + 4;
}

// Where the band tables start: after the mbarriers, the ring, the
// magnitude tile (NB + 1 bins) and the staged sample rows (through frame
// TF-1's window rounded up to whole slabs), at a 16-byte boundary.
__host__ __device__ __forceinline__ size_t tables_offset(int mt, int win,
                                                         int hop,
                                                         int stages) {
  const int tf = 16 * mt;
  const int win_p = (win + KS - 1) / KS * KS;
  const size_t rows = tf + (win_p - 1) / hop;
  const size_t end = msv::kRingOffset + stages * SLAB_BYTES +
                     sizeof(float) * (static_cast<size_t>(NB + 1) * (tf + 1) +
                                      rows * sample_stride(hop));
  return (end + 15) / 16 * 16;
}

// MT m-tiles of 16 frames per block; every warp covers all of them.
template <typename T, int MT>
__global__ void __launch_bounds__(32 * WARPS, 1)
mel_db_tf32_kernel(const T* __restrict__ wave, long long wave_stride,
                   long long wave_len, const msv::Prepared<float> ops,
                   float* __restrict__ out, int win, int hop, int n_frames,
                   int n_freq, int n_mel, int stages) {
  constexpr int TF = 16 * MT;
  constexpr int P = 32 * WARPS / TF;  // threads per frame, leftover bin
  extern __shared__ __align__(128) unsigned char smem[];
  const int win_p = (win + KS - 1) / KS * KS;
  const int n_k = win_p / KS;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  const msv::Ring ring{bars, bars + msv::kMaxStages, smem + msv::kRingOffset,
                       reinterpret_cast<const unsigned char*>(ops.slabs),
                       SLAB_BYTES, stages, ops.n_tiles * n_k};
  constexpr int MS = msv::mag_stride<TF, float>();
  float* mag = reinterpret_cast<float*>(smem + msv::kRingOffset +
                                        stages * SLAB_BYTES);  // [NB+1][MS]
  float* chunk = mag + (NB + 1) * MS;  // overlapping rows at stride hs
  const int rl = row_len(hop), hs = sample_stride(hop);
  const int rows = TF + (win_p - 1) / hop;
  unsigned char* tables = smem + tables_offset(MT, win, hop, stages);

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * 32 + lane;
  const int g = lane >> 2;   // mma group: fragment row / B column
  const int tig = lane & 3;  // thread in group: fragment column
  const int f0 = blockIdx.x * TF;
  const T* w = wave + static_cast<long long>(blockIdx.y) * wave_stride;
  const long long base = static_cast<long long>(f0) * hop;

  ring.start(tid);
  for (int r = warp; r < rows; r += WARPS) {  // row r: samples r*hop on
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
        if (c < rl) chunk[r * hs + c] = v[u];
      }
    }
  }
  const msv::BandTables<float> tb = msv::stage_tables(tables, ops, n_mel, tid);
  __syncthreads();

  float* o = out + (static_cast<long long>(blockIdx.y) * n_frames + f0) * n_mel;
  const int nf = min(TF, n_frames - f0);
  const int wn0 = warp * WCOLS;  // this warp's first bin in the tile
  // this thread's A rows: frames mt*16 + g and mt*16 + g + 8, column tig
  int arow[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) arow[mt][h] = (mt * 16 + g + 8 * h) * hs + tig;
  msv::Ring::Cursor cur;

  for (int t = 0; t < ops.n_tiles; ++t) {
    // [C or S][m-tile][n-tile][fragment]: the tile's sums so far
    float acc[2][MT][2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[m][mt][nt][q] = 0.0f;
    // the k-step's samples n0..n0+7 of every frame: row offset j (as koff,
    // with the column) and column c0 = n0 - j*hop; uniform across the warp
    int koff = 0, c0 = 0;

    for (int j = 0; j < n_k; ++j) {
      const float* cs = reinterpret_cast<const float*>(ring.acquire(cur));
      float part[2][MT][2][4];  // this slab's products
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int r = 0; r < 4; ++r) part[m][mt][nt][r] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KS; kk += 8) {
        kstep<MT>(part, cs, kk, chunk + koff, arow, wn0, g, tig);
        koff += 8;
        c0 += 8;
        while (c0 >= hop) {  // the next row
          c0 -= hop;
          koff += hs - hop;
        }
      }
      ring.release_all(cur, tid);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[m][mt][nt][r] += part[m][mt][nt][r];
    }

    // every warp is done with the last tile's mel pass and these slabs
    msv::consumer_sync();
    // |X| in f32 into mag[bin][frame], for the bins the products cover
    const int k0 = t * NB;
    const int nv = min(NB, n_freq - 1 - k0);
    store_magnitude<MT>(mag, acc, nv, wn0, g, tig);
    int kt = NB;
    if (t == ops.n_tiles - 1) {  // the leftover bin n_freq - 1, column nv
      const float* tl = msv::stage_tail(smem + msv::kRingOffset,
                                        stages * SLAB_BYTES, ops.tail, win,
                                        tid);
      msv::consumer_sync();
      const float2 v = msv::leftover_bin<TF>(chunk, hs, hop, tl, win, tid);
      if (tid % P == 0) mag[nv * MS + tid / P] = sqrtf(v.x * v.x + v.y * v.y);
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
// sample of their frames' windows.  The samples arrive in chunks of kc
// along the window (msv::stage_chunk: one row of kc + 4 floats a frame, 4
// mod 8 words), staged again for every frequency tile; the band tables are
// read where they are in device memory (L1 and L2 keep them), not copied
// into shared memory; the leftover bin sums chunk by chunk in the last
// tile, with its kept columns read from device memory.  The products, the
// magnitude, the mel pass and the dB are the kernel above's.
__host__ __device__ __forceinline__ int chunk_stride(int kc) { return kc + 4; }

template <typename T, int MT>
__global__ void __launch_bounds__(32 * WARPS, 1)
mel_db_tf32_chunked_kernel(const T* __restrict__ wave, long long wave_stride,
                           long long wave_len, const msv::Prepared<float> ops,
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
  constexpr int MS = msv::mag_stride<TF, float>();
  float* mag = reinterpret_cast<float*>(smem + msv::kRingOffset +
                                        stages * SLAB_BYTES);  // [NB+1][MS]
  float* chunk = mag + (NB + 1) * MS;  // frame f's samples at f * cs
  const int cs = chunk_stride(kc);
  const msv::BandTables<float> tb{ops.bands, ops.woff, ops.wts};

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

  float* o = out + (static_cast<long long>(blockIdx.y) * n_frames + f0) * n_mel;
  const int nf = min(TF, n_frames - f0);
  const int wn0 = warp * WCOLS;
  int arow[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) arow[mt][h] = (mt * 16 + g + 8 * h) * cs + tig;
  msv::Ring::Cursor cur;

  for (int t = 0; t < ops.n_tiles; ++t) {
    const bool last = t == ops.n_tiles - 1;
    float acc[2][MT][2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[m][mt][nt][q] = 0.0f;
    float2 left = make_float2(0.0f, 0.0f);  // the leftover bin, last tile

    for (int k0 = 0; k0 < win_p; k0 += kc) {
      const int len = min(kc, win_p - k0);
      msv::consumer_sync();  // every warp is done with the last chunk
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
        const float* cs_ = reinterpret_cast<const float*>(ring.acquire(cur));
        float part[2][MT][2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int r = 0; r < 4; ++r) part[m][mt][nt][r] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < KS; kk += 8)
          kstep<MT>(part, cs_, kk, chunk + j + kk, arow, wn0, g, tig);
        ring.release_all(cur, tid);
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int r = 0; r < 4; ++r)
                acc[m][mt][nt][r] += part[m][mt][nt][r];
      }
    }

    // every warp is done with the last tile's mel pass
    msv::consumer_sync();
    const int k0 = t * NB;
    const int nv = min(NB, n_freq - 1 - k0);
    store_magnitude<MT>(mag, acc, nv, wn0, g, tig);
    int kt = NB;
    if (last) {  // the leftover bin n_freq - 1, column nv
      if (tid % P == 0)
        mag[nv * MS + tid / P] = sqrtf(left.x * left.x + left.y * left.y);
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
         msv::table_bytes(n_mel, n_wts, sizeof(float));
}

// Shared memory besides the ring: chunked tier.
size_t chunked_fixed_bytes(int mt, int kc) {
  const size_t tf = 16 * mt;
  return msv::kRingOffset +
         sizeof(float) * ((NB + 1) * (tf + 1) + tf * chunk_stride(kc));
}

template <typename T, int MT>
int launch_mt(const void* wave, long long wave_stride, long long wave_len,
              int batch, const msv::Prepared<float>& ops, float* out, int win,
              int hop, int n_frames, int n_freq, int n_mel, int stages,
              int kc, msv::Plan* plan, cudaStream_t stream) {
  const bool chunked = kc > 0;
  const size_t smem =
      (chunked ? chunked_fixed_bytes(MT, kc)
               : fixed_bytes(MT, win, hop, n_mel, ops.n_wts)) +
      stages * SLAB_BYTES;
  *plan = {chunked ? msv::kChunked : msv::kResident, MT, stages, kc,
           static_cast<int>(smem), plan->avail};
  const dim3 grid((n_frames + 16 * MT - 1) / (16 * MT), batch);
  const dim3 block(32, WARPS);
  const T* w = static_cast<const T*>(wave);
  cudaError_t err;
  if (chunked) {
    err = cudaFuncSetAttribute(mel_db_tf32_chunked_kernel<T, MT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    mel_db_tf32_chunked_kernel<T, MT><<<grid, block, smem, stream>>>(
        w, wave_stride, wave_len, ops, out, win, hop, n_frames, n_freq,
        n_mel, stages, kc);
  } else {
    err = cudaFuncSetAttribute(mel_db_tf32_kernel<T, MT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    mel_db_tf32_kernel<T, MT><<<grid, block, smem, stream>>>(
        w, wave_stride, wave_len, ops, out, win, hop, n_frames, n_freq,
        n_mel, stages);
  }
  return static_cast<int>(cudaGetLastError());
}

// The resident tier: the most m-tiles (4, 2, then 1) whose block fits with
// a ring of three stages (more frames per block means fewer slab copies per
// frame).  Else the chunked tier's one plan, where it fits with three
// stages.  Else nothing is launched.
template <typename T>
int launch(const void* wave, long long wave_stride, long long wave_len,
           int batch, const msv::Prepared<float>& ops, float* out, int win,
           int hop, int n_frames, int n_freq, int n_mel, msv::Plan* plan,
           cudaStream_t stream) {
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

// wave: (batch, wave_stride) f32 or int16 (wave_is_i16), wave_len valid
// samples per row; then a prepare_operands record (f32): slabs: n_tiles *
// ceil(win / ks) slabs (16-byte aligned) of ks rows x nb bins at row stride
// row_stride, which must be this kernel's KS, NB and ROW; tail: (win, 2),
// the columns of bin n_freq - 1 of C and S; wts: (n_wts,) each band's
// filterbank weights over its bins, band m's from woff[m]; bands: (n_mel,
// 2) int32 [lo, hi) bin support of each band; tile_bands: (n_tiles, 2)
// int32, the bands [ma, mb) each frequency tile meets.  out: (batch,
// n_frames, n_mel) f32.  plan: 6 ints, the launcher's choice (msv::Plan).
// Launches on `stream` without synchronising; returns the launch's
// cudaError_t (cudaErrorInvalidConfiguration, launching nothing, where no
// tier fits: then plan's tier is 0 and its smem the least a block needs).
int msv_mel_spectrogram(const void* wave, int wave_is_i16,
                        long long wave_stride, long long wave_len, int batch,
                        const void* slabs, const void* tail, const void* wts,
                        const int* bands, const int* woff,
                        const int* tile_bands, float* out,
                        int win, int hop, int n_frames, int n_freq, int n_mel,
                        int n_tiles, int n_wts, int ks, int nb,
                        int row_stride, void* stream, int* plan) {
  if (ks != KS || nb != NB || row_stride != ROW || n_tiles < 1 ||
      reinterpret_cast<uintptr_t>(slabs) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const msv::Prepared<float> ops{static_cast<const float*>(slabs),
                                 static_cast<const float*>(tail),
                                 static_cast<const float*>(wts), bands, woff,
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

const char* msv_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
