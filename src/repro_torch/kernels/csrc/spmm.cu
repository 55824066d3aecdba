// SpMM: a sparse matrix times a dense multi-RHS panel X (n, k), in ELL and
// BSR layouts, in CUDA for sm_90a.  f32 values and X, int32 indices, f32
// accumulation.
//
// spmm_ell_kernel replaces the Pallas TPU kernel
// src/repro/kernels/spmm.py:41 (spmm_ell_kernel), which walks (row block,
// RHS panel, width block) tiles with the whole X panel in VMEM and gathers
// rows of it inside the tile.  A CTA's shared memory cannot hold X at the
// main path's sizes (mod2as n = 10240 at k = 64 is 2.6 MB), and gathering
// each stored entry's row of X from L2 (256 bytes an entry at k = 64, 1.8
// GB a call for 6.9 M stored entries) bounds a kernel by L2 bandwidth, at
// many times the HBM bound.  So here a CTA owns a tile of rows and a panel
// of up to 64 columns of X, and sweeps X through shared memory in chunks
// of rows, so that each staged row of X serves every entry of the tile
// that names it:
//
//   CTA = (row tile, panel of 32 * CPL columns); warp w walks RPW rows,
//         one lane per CPL columns, its accumulators in registers
//   for each chunk [lo, end) of X's rows:       (one barrier a chunk)
//     start the copy of the next chunk, wait for this one
//     for each of the warp's rows:
//       add the row's entries from its pointer on while col < end
//
// The chunks are double-buffered: warp 0 hands them to the TMA as bulk
// copies that complete on an mbarrier (cp.async.bulk; 4-byte cp.async
// where k is not a multiple of 4 or above 64), so no walking thread
// stalls on issuing them.  A
// row's entries reach the warp through a window of 64 (col, value) pairs
// in shared memory, refilled from registers that were loaded one window
// (about two chunks) ahead; the warp finds the run of the window that the
// chunk takes with four ballots and reads it two entries a load, up to
// eight rows of X in flight.  The walk assumes nothing about the order of a
// row's columns: it stops a row at the first entry at or past the chunk's
// end, and an entry below the chunk (a row not in ascending order) reads
// its row of X from global memory where it stands; the last chunk takes
// every entry that is left.  Padding (value 0, column 0, as ell_from_csr
// writes it at a row's end) adds 0 * X[0, :]: where X[0, :] is finite in
// the panel that is exactly 0, so a row's trailing padding is passed over;
// where it is not, the padding is added and gives NaN, as in the
// reference.  So the sum over every stored entry is taken in an order
// fixed by the data alone: y is bitwise the same from run to run.  Ragged
// nrows and k are masked in the kernel; kernels/spmm.py ell_partition
// sizes the tile, the chunk and the warps from the shape and the SM count
// (one CTA of 80 rows per SM at mod2as).  Where a CTA's stored entries
// are fewer than X's rows (each staged row would serve less than one
// entry; the SpMM suite's uniform class, 16 a row at n = 1024), nothing is
// staged and every entry, padding included, gathers its row of X from
// global memory, up to sixteen loads in flight.
//
// spmm_bsr_kernel replaces src/repro/kernels/spmm.py:91 (spmm_bsr_kernel),
// a recorded loop over one block-row's live blocks with a (bs, bs) x
// (bs, bn) product per block.  Here a CTA owns one block-row and a panel
// of 32 columns of X.  For each live block it stages the bs x bs tile and
// the matching bs x 32 strip of X in shared memory; each thread keeps up
// to 8 outputs of the (bs, 32) output tile in registers (rows ty, ty + 8,
// ...).  Block edges 8, 16, 32 and 64 are compiled in; any other edge up
// to 64 runs the same kernel with bs as an argument.  Ragged k is masked;
// a block-row with no live blocks writes zeros.
//
// Bound on this card.  ELL: each stored nonzero is read once (8 bytes) and
// drives k FMAs on a row of X: at mod2as (n = 10240, width 675, 6.0 M
// nonzeros) and k = 64, 55 MB bound it by bytes near 16 us.  This design
// is held by shared memory instead: every stored entry reads k * 4 bytes
// of its staged X row (1.5 GB a call at 128 bytes a clock an SM, about 2.5
// clocks an entry with the window's reads), and each CTA copies all of X
// once from L2 (2.6 MB per SM).  BSR: 8 bytes of index per block and 4
// bytes per stored value, each driving k FMAs; at the SpGEMM suite's
// clustered operand (n = 2048, bs 8, 13 k blocks) and k = 64 it is
// bytes-bound at a few microseconds and latency-bound in practice (one CTA
// per block-row and k panel, 512 CTAs).
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int ELL_WIN = 64;  // entries of a row in shared memory at once
constexpr uint32_t ELL_PIECE = 16384;  // bytes of X a bulk copy moves
constexpr int BSR_THREADS = 256;
constexpr int BSR_PANEL = 32;  // columns of X per CTA (one warp wide)
constexpr int BSR_MAX = 64;    // the largest block edge

struct EllArgs {
  const float* values;  // (nrows, width)
  const int* cols;      // (nrows, width)
  const float* x;       // (n, k)
  float* y;             // (nrows, k)
  int nrows, width, n, k;
  int chunk;    // rows of X per chunk
  int nchunks;  // ceil(n / chunk)
  int nbuf;     // chunk buffers: 1 (one chunk) or 2
  int stride;   // floats per staged row of X (the panel's width, padded)
  bool vec;     // TMA bulk copies of X (one panel, k % 4 == 0, aligned)
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The producer warp's copy of X's rows [lo, lo + rows) x columns
// [p0, p0 + pw) into xs, to complete on *bar.  vec (the panel is all of
// X's columns, in 16-byte rows): the chunk is one contiguous block of X,
// handed to the TMA as bulk copies of ELL_PIECE bytes; else 4-byte
// cp.async by every lane, each lane arriving on *bar when its copies land.
__device__ __forceinline__ void stage_chunk(const EllArgs& a, float* xs,
                                            int lo, int rows, int p0,
                                            int pw, uint64_t* bar, int lane) {
  const float* src = a.x + (size_t)lo * a.k + p0;
  const uint32_t b = smem_u32(bar);
  if (a.vec) {
    const uint32_t bytes = 4u * rows * pw;
    if (lane == 0)
      asm volatile(
          "fence.proxy.async.shared::cta;\n"
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
          "r"(bytes)
          : "memory");
    __syncwarp();
    for (uint32_t off = lane * ELL_PIECE; off < bytes; off += 32 * ELL_PIECE)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(xs + off / 4)),
          "l"(src + off / 4), "r"(min(ELL_PIECE, bytes - off)), "r"(b)
          : "memory");
    return;
  }
  for (int i = lane; i < rows * pw; i += 32) {
    const int r = i / pw, c = i - r * pw;
    cp_async4(xs + r * a.stride + c, src + (size_t)r * a.k + c);
  }
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   b)
               : "memory");
}

// Wait until *bar completed phase `parity`.
__device__ __forceinline__ void wait_chunk(uint64_t* bar, int parity) {
  const uint32_t b = smem_u32(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
}

// acc += value * the lane's CPL columns of row `col` of the staged chunk
// (xrow: the lane's column 0 of the chunk's row 0, minus lo rows).
template <int CPL>
__device__ __forceinline__ void ell_add(float2 e, const float* xrow,
                                        int stride, float (&acc)[CPL]) {
  const float* xr = xrow + __float_as_int(e.x) * stride;
  if constexpr (CPL == 2) {
    const float2 v = *reinterpret_cast<const float2*>(xr);
    acc[0] = fmaf(e.y, v.x, acc[0]);
    acc[1] = fmaf(e.y, v.y, acc[1]);
  } else {
    acc[0] = fmaf(e.y, xr[0], acc[0]);
  }
}

// ell_add over entries j .. j + G - 1 of a window (j even): the window in
// pairs and all G rows of X loaded first, so that they are in flight at
// once, then added in order.
template <int CPL, int G>
__device__ __forceinline__ void ell_group(const float2* win, int j,
                                          const float* xrow, int stride,
                                          float (&acc)[CPL]) {
  const float4* win2 = reinterpret_cast<const float4*>(win) + (j >> 1);
  float2 e[G];
#pragma unroll
  for (int q = 0; q < G; q += 2) {
    const float4 p = win2[q >> 1];
    e[q] = make_float2(p.x, p.y);
    e[q + 1] = make_float2(p.z, p.w);
  }
  float xv[G][CPL];
#pragma unroll
  for (int q = 0; q < G; ++q) {
    const float* xr = xrow + __float_as_int(e[q].x) * stride;
    if constexpr (CPL == 2) {
      const float2 v = *reinterpret_cast<const float2*>(xr);
      xv[q][0] = v.x;
      xv[q][1] = v.y;
    } else {
      xv[q][0] = xr[0];
    }
  }
#pragma unroll
  for (int q = 0; q < G; ++q)
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[c] = fmaf(e[q].y, xv[q][c], acc[c]);
}

// The same with X's rows from global memory (xg: the lane's column 0 of
// X's row 0; nv of the lane's CPL columns lie in the panel).
template <int CPL, int G>
__device__ __forceinline__ void ell_gather(const float2* win, int j,
                                           const float* xg, int k, int nv,
                                           float (&acc)[CPL]) {
  float2 e[G];
  float xv[G][CPL];
#pragma unroll
  for (int q = 0; q < G; ++q) e[q] = win[j + q];
#pragma unroll
  for (int q = 0; q < G; ++q) {
    const float* xr = xg + (size_t)__float_as_int(e[q].x) * k;
#pragma unroll
    for (int c = 0; c < CPL; ++c) xv[q][c] = c < nv ? __ldg(xr + c) : 0.f;
  }
#pragma unroll
  for (int q = 0; q < G; ++q)
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[c] = fmaf(e[q].y, xv[q][c], acc[c]);
}

// One entry of a row as a (column bits, value) pair; outside the row a
// pair that no walk takes.
__device__ __forceinline__ float2 ell_entry(const EllArgs& a, int row,
                                            int e) {
  if (row >= a.nrows || e < 0 || e >= a.width) return make_float2(0.f, 0.f);
  const size_t i = (size_t)row * a.width + e;
  return make_float2(__int_as_float(__ldg(a.cols + i)), __ldg(a.values + i));
}

// The CTA's last warp copies the chunks; the others walk rows.  At most 20
// walking warps a CTA with RPW 4, 15 with RPW 1 (kernels/spmm.py
// ell_partition), so that a thread may take 80 or 128 registers.
// GATHER: the instantiation for a.nchunks == 0 (X's rows gathered from
// global memory); the others never take that path, which keeps it out of
// their registers.  It has no chunks to wait for and no padding scan: a
// row's few entries are all added (padding adds 0 * X[0, :]), so its
// dependent global reads are the window and one group of X's rows.
template <int CPL, int RPW, bool GATHER>
__global__ void __launch_bounds__(RPW == 4 ? 672 : 512)
    spmm_ell_kernel(const EllArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int panel = 32 * CPL;
  const int p0 = blockIdx.y * panel;
  const int pw = min(panel, a.k - p0);
  const bool act = lane * CPL < pw;  // lanes past the panel only walk
  // the warps' row windows first (16-byte aligned), then the X buffers
  const int walkers = (blockDim.x >> 5) - 1;
  const int rows = walkers * RPW;
  float2* ring = reinterpret_cast<float2*>(smem) + warp * RPW * ELL_WIN;
  float* xs = smem + 2 * rows * ELL_WIN;
  const int row0 = blockIdx.x * rows + warp * RPW;

  // full[b]: chunk buffer b holds its chunk; empty[b]: every walking warp
  // is done with it
  __shared__ uint64_t full[2], empty[2];
  if (!GATHER && threadIdx.x == 0) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       smem_u32(full + b)),
                   "r"(a.vec ? 1 : 32)
                   : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       smem_u32(empty + b)),
                   "r"(walkers)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (!GATHER) __syncthreads();
  if (warp == walkers) {  // the producer: chunk ch into buffer ch % nbuf
    for (int ch = 0; ch < a.nchunks; ++ch) {
      const int b = ch % a.nbuf;
      if (ch >= a.nbuf) wait_chunk(empty + b, (ch / a.nbuf - 1) & 1);
      const int lo = ch * a.chunk;
      stage_chunk(a, xs + (size_t)b * a.chunk * a.stride, lo,
                  min(a.chunk, a.n - lo), p0, pw, full + b, lane);
    }
    return;
  }

  // X[0, :] finite in the panel: then padding (value 0, column 0) at a
  // row's end adds exactly 0 and is passed over; else it is added
  bool fin = true;
#pragma unroll
  for (int t = 0; t < CPL; ++t)
    if (!GATHER && act && lane * CPL + t < pw)
      fin &= isfinite(__ldg(a.x + p0 + lane * CPL + t));
  const bool x0fin = !GATHER && __all_sync(FULL, fin);

  // per row: where its walk ends (the width, less the trailing padding
  // where X[0, :] is finite), the next entry to take, the first entry of
  // the window in shared memory, and the window after it in registers (two
  // a lane)
  int wend[RPW], ptr[RPW], wb[RPW];
  float2 pf[RPW][2];
  float acc[RPW][CPL];
#pragma unroll
  for (int s = 0; s < RPW; ++s) {
    wend[s] = row0 + s < a.nrows ? a.width : 0;
    while (x0fin && wend[s] > 0) {  // 32 entries from the end at a time
      const float2 e = ell_entry(a, row0 + s, wend[s] - 1 - lane);
      const unsigned live = __ballot_sync(
          FULL, lane < wend[s] && !(__float_as_int(e.x) == 0 && e.y == 0.f));
      if (live) {
        wend[s] -= __ffs(live) - 1;
        break;
      }
      wend[s] = max(0, wend[s] - 32);
    }
    ptr[s] = 0;
    wb[s] = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ring[s * ELL_WIN + h * 32 + lane] = ell_entry(a, row0 + s, h * 32 + lane);
      pf[s][h] = ell_entry(a, row0 + s, ELL_WIN + h * 32 + lane);
    }
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[s][c] = 0.f;
  }

  // no chunks (a.chunk == 0): one pass in which every entry gathers its
  // row of X from global memory
  const int passes = max(a.nchunks, 1);
  for (int ch = 0; ch < passes; ++ch) {
    const int b = ch % a.nbuf;
    if (a.nchunks) wait_chunk(full + b, (ch / a.nbuf) & 1);
    const int lo = ch * a.chunk;
    const int end = min(a.n, lo + a.chunk);
    const int hi = ch + 1 == passes ? INT_MAX : end;
    const float* xb = xs + (size_t)b * a.chunk * a.stride + lane * CPL;
    const float* xrow = xb - (size_t)lo * a.stride;  // row `col` at col
#pragma unroll
    for (int s = 0; s < RPW; ++s) {
      float2* win = ring + s * ELL_WIN;
      while (ptr[s] < wend[s]) {  // uniform across the warp
        if (ptr[s] == wb[s] + ELL_WIN) {  // window used up: the next one
          __syncwarp();
          win[lane] = pf[s][0];
          win[32 + lane] = pf[s][1];
          __syncwarp();
          wb[s] += ELL_WIN;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            pf[s][h] = ell_entry(a, row0 + s, wb[s] + ELL_WIN + h * 32 + lane);
        }
        // the run: from j0 to the first entry at or past hi, or the walk's
        // end; out: run entries outside the staged chunk
        const int j0 = ptr[s] - wb[s];
        const float2 e0 = win[lane], e1 = win[32 + lane];
        unsigned long long stop = 0, out = 0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = h * 32 + lane;
          const int col = __float_as_int((h ? e1 : e0).x);
          const bool mine = j >= j0;
          stop |= (unsigned long long)__ballot_sync(
                      FULL, mine && (wb[s] + j >= wend[s] || col >= hi))
                  << (32 * h);
          out |= (unsigned long long)__ballot_sync(
                     FULL, mine && (col < lo || col >= end))
                 << (32 * h);
        }
        const int jl = stop ? __ffsll(stop) - 1 : ELL_WIN;
        out &= jl == ELL_WIN ? ~0ull : (1ull << jl) - 1;
        if (act) {
          int j = j0;
          if (!out) {  // the whole run is in the chunk
            if (j & 1 && j < jl) ell_add<CPL>(win[j++], xrow, a.stride, acc[s]);
            for (; j + 8 <= jl; j += 8)
              ell_group<CPL, 8>(win, j, xrow, a.stride, acc[s]);
            if (j + 4 <= jl) {
              ell_group<CPL, 4>(win, j, xrow, a.stride, acc[s]);
              j += 4;
            }
            if (j + 2 <= jl) {
              ell_group<CPL, 2>(win, j, xrow, a.stride, acc[s]);
              j += 2;
            }
            if (j < jl) ell_add<CPL>(win[j], xrow, a.stride, acc[s]);
          } else if (GATHER) {  // nothing staged: gather, G at a time
            constexpr int G = RPW == 4 ? 4 : 16;  // registers: 4 rows a warp
            const float* xg = a.x + p0 + lane * CPL;
            const int nv = min(CPL, pw - lane * CPL);
            for (; j + G <= jl; j += G)
              ell_gather<CPL, G>(win, j, xg, a.k, nv, acc[s]);
            for (; j < jl; ++j)
              ell_gather<CPL, 1>(win, j, xg, a.k, nv, acc[s]);
          } else {
            for (; j < jl; ++j) {
              const float2 e = win[j];
              const int c = __float_as_int(e.x);
              if (c >= lo && c < end) {
                ell_add<CPL>(e, xrow, a.stride, acc[s]);
              } else {  // outside the chunk: X's row from global memory
                const float* xr = a.x + (size_t)c * a.k + p0 + lane * CPL;
#pragma unroll
                for (int u = 0; u < CPL; ++u)
                  if (lane * CPL + u < pw)
                    acc[s][u] = fmaf(e.y, __ldg(xr + u), acc[s][u]);
              }
            }
          }
        }
        ptr[s] = wb[s] + jl;
        if (jl < ELL_WIN) break;  // past the chunk, or the walk's end
      }
    }
    __syncwarp();  // the warp is done with buffer b
    if (!GATHER && lane == 0)
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                       smem_u32(empty + b))
                   : "memory");
  }
#pragma unroll
  for (int s = 0; s < RPW; ++s) {
    if (row0 + s >= a.nrows) break;
    float* yr = a.y + (size_t)(row0 + s) * a.k + p0 + lane * CPL;
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      if (lane * CPL + c < pw) yr[c] = acc[s][c];
  }
}

template <int CPL, int RPW, bool GATHER>
int launch_ell(const EllArgs& a, int nwarps, cudaStream_t stream) {
  const int rows = nwarps * RPW;
  const dim3 grid((a.nrows + rows - 1) / rows,
                  (a.k + 32 * CPL - 1) / (32 * CPL));
  const size_t bytes = sizeof(float) * (size_t)a.nbuf * a.chunk * a.stride +
                       sizeof(float2) * (size_t)rows * ELL_WIN;
  auto kernel = spmm_ell_kernel<CPL, RPW, GATHER>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, (nwarps + 1) * 32, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// BS > 0: a compiled block edge (a multiple of 8), its tiles in static
// shared memory; BS == 0: the edge is the argument bs (1..64), shared
// memory sized at launch.
template <int BS>
__global__ void __launch_bounds__(BSR_THREADS)
    spmm_bsr_kernel(const float* __restrict__ values,
                    const int* __restrict__ cols, const int* __restrict__ rowp,
                    const float* __restrict__ x, float* __restrict__ y,
                    int bs_arg, int k) {
  constexpr int ROWS_PER_PASS = BSR_THREADS / BSR_PANEL;           // 8
  constexpr int RPT = (BS ? BS : BSR_MAX) / ROWS_PER_PASS;         // <= 8
  const int bs = BS ? BS : bs_arg;
  __shared__ float blk_s[BS ? BS * BS : 1], xs_s[BS ? BS * BSR_PANEL : 1];
  extern __shared__ __align__(16) float bsm[];
  float* blk = BS ? blk_s : bsm;           // (bs, bs)
  float* xs = BS ? xs_s : bsm + bs * bs;   // (bs, BSR_PANEL)
  const int brow = blockIdx.x;
  const int c0 = blockIdx.y * BSR_PANEL;
  const int tx = threadIdx.x % BSR_PANEL;
  const int ty = threadIdx.x / BSR_PANEL;
  float acc[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) acc[r] = 0.f;
  const int start = __ldg(rowp + brow);
  const int stop = __ldg(rowp + brow + 1);
  for (int p = start; p < stop; ++p) {
    const float* vp = values + (size_t)p * bs * bs;
    for (int e = threadIdx.x; e < bs * bs; e += BSR_THREADS)
      blk[e] = __ldg(vp + e);
    const float* xp = x + (size_t)__ldg(cols + p) * bs * k;
    for (int e = threadIdx.x; e < bs * BSR_PANEL; e += BSR_THREADS) {
      const int r = e / BSR_PANEL;
      const int c = c0 + e % BSR_PANEL;
      xs[e] = c < k ? __ldg(xp + (size_t)r * k + c) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int i = ty + r * ROWS_PER_PASS;
      if (BS == 0 && i >= bs) break;
#pragma unroll
      for (int t = 0; t < bs; ++t)
        acc[r] = fmaf(blk[i * bs + t], xs[t * BSR_PANEL + tx], acc[r]);
    }
    __syncthreads();
  }
  const int col = c0 + tx;
  if (col >= k) return;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int i = ty + r * ROWS_PER_PASS;
    if (BS == 0 && i >= bs) break;
    y[((size_t)brow * bs + i) * k + col] = acc[r];
  }
}

template <int BS>
int launch_bsr(const void* values, const void* cols, const void* rowp,
               const void* x, void* y, int nbrows, int bs, int k,
               cudaStream_t stream) {
  const dim3 grid(nbrows, (k + BSR_PANEL - 1) / BSR_PANEL);
  const size_t bytes =
      BS ? 0 : sizeof(float) * (size_t)bs * (bs + BSR_PANEL);
  spmm_bsr_kernel<BS><<<grid, BSR_THREADS, bytes, stream>>>(
      static_cast<const float*>(values), static_cast<const int*>(cols),
      static_cast<const int*>(rowp), static_cast<const float*>(x),
      static_cast<float*>(y), bs, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cpl: columns a lane owns (1: panels of 32, 2: panels of 64); rpw: rows a
// warp walks (1 or 4); nwarps: walking warps (the CTA has one more); chunk:
// rows of X a chunk stages (0: none, every entry gathers its row of X), as
// kernels/spmm.py ell_partition gives them.  The chunk count, the buffers
// and the staged rows' stride follow from these here, as EllPartition's
// methods work them out for its shared-memory budget.
extern "C" int spmm_ell_launch(const void* values, const void* cols,
                               const void* x, void* y, int nrows, int width,
                               int n, int k, int cpl, int rpw, int nwarps,
                               int chunk, void* stream) {
  if (cpl < 1 || cpl > 2 || nwarps < 1 || chunk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int pw = k < 32 * cpl ? k : 32 * cpl;
  const int nchunks = chunk ? (n + chunk - 1) / chunk : 0;
  EllArgs a{static_cast<const float*>(values), static_cast<const int*>(cols),
            static_cast<const float*>(x), static_cast<float*>(y),
            nrows, width, n, k, chunk, nchunks, nchunks > 1 ? 2 : 1,
            cpl * ((pw + cpl - 1) / cpl), false};
  // one panel that is all of X's columns (k % 4 == 0 makes the stride k):
  // a chunk is a contiguous block
  a.vec = k <= 32 * cpl && k % 4 == 0 &&
          reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool g = nchunks == 0;
  if (cpl == 1 && rpw == 1)
    return g ? launch_ell<1, 1, true>(a, nwarps, s)
             : launch_ell<1, 1, false>(a, nwarps, s);
  if (cpl == 1 && rpw == 4)
    return g ? launch_ell<1, 4, true>(a, nwarps, s)
             : launch_ell<1, 4, false>(a, nwarps, s);
  if (cpl == 2 && rpw == 1)
    return g ? launch_ell<2, 1, true>(a, nwarps, s)
             : launch_ell<2, 1, false>(a, nwarps, s);
  if (cpl == 2 && rpw == 4)
    return g ? launch_ell<2, 4, true>(a, nwarps, s)
             : launch_ell<2, 4, false>(a, nwarps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int spmm_bsr_launch(const void* values, const void* cols,
                               const void* rowp, const void* x, void* y,
                               int nbrows, int bs, int k, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bs) {
    case 8:
      return launch_bsr<8>(values, cols, rowp, x, y, nbrows, bs, k, s);
    case 16:
      return launch_bsr<16>(values, cols, rowp, x, y, nbrows, bs, k, s);
    case 32:
      return launch_bsr<32>(values, cols, rowp, x, y, nbrows, bs, k, s);
    case 64:
      return launch_bsr<64>(values, cols, rowp, x, y, nbrows, bs, k, s);
    default:
      if (bs < 1 || bs > BSR_MAX)
        return static_cast<int>(cudaErrorInvalidValue);
      return launch_bsr<0>(values, cols, rowp, x, y, nbrows, bs, k, s);
  }
}
