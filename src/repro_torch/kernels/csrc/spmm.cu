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
// (bs, bn) product per block.  Carried over block by block, that loop is a
// chain of dependent memory round trips on this card (one block, two CTA
// barriers, the next block).  Here the unit of work is (block-row, panel
// of X's columns):
//
//   CTA  = (block-row, panel); the row's blocks are cut into `warps`
//          contiguous ranges, one a warp, in order (kernels/spmm.py
//          bsr_partition sizes the panel, the lanes and the warps; the
//          launcher takes as many of those warps as its stages fit in
//          shared memory)
//   warp = a ring of BSR_STAGES stages in shared memory: blocks j + 1 ..
//          j + 3 of its range are in flight (cp.async: 16-byte pieces
//          where bs, k and the panel are multiples of 4 and the operands
//          16-byte aligned, else 4-byte) while block j is multiplied, with
//          no barrier but the warp's own; its (bs, panel) partial in
//          registers, a lane owning RPL rows x 2 columns
//   then   the warps' partials are added in shared memory in warp order
//          and y is written once
//
// The panel is shaped from k: at most 64 columns and at most 1024 / bs,
// so that a lane keeps at most 32 outputs; at k <= 32 the panel is k
// itself and the lanes cover (row, column) pairs of the bs x k tile, so
// that none idles at k = 8.  Each output is an FMA chain over t in order,
// block by block in p order, the ranges added in order: y is the same bit
// for bit from run to run, with no float atomics.  A block's rows are
// staged with a stride that puts the lanes' rows on distinct banks.
// Ragged bs, k and panels are masked; an empty block-row writes zeros.
// Edges 1..64 run here; kernels/spmm.py re-cuts a larger edge into
// sub-blocks of a divisor first.
//
// Bound on this card.  ELL: each stored nonzero is read once (8 bytes) and
// drives k FMAs on a row of X: at mod2as (n = 10240, width 675, 6.0 M
// nonzeros) and k = 64, 55 MB bound it by bytes near 16 us.  This design
// is held by shared memory instead: every stored entry reads k * 4 bytes
// of its staged X row (1.5 GB a call at 128 bytes a clock an SM, about 2.5
// clocks an entry with the window's reads), and each CTA copies all of X
// once from L2 (2.6 MB per SM).  BSR: 4 bytes per stored value and 4 of
// index per block, each value driving k FMAs; at the SpGEMM suite's
// clustered 0.2 operand (n = 2048, bs 8, 13,052 blocks) and k = 64 the
// bound is its 107 MFLOP at the f32 FMA rate, 1.6 us.  This design is held
// by L2 instead: every block reads its bs x k strip of X there (2 KB, 27 MB
// a call), and a warp's first block waits on three dependent loads (rowp,
// cols, the block).  So it stays on the FMA units in f32: TF32 mma would
// loosen the sums and buys nothing this far from the FMA peak.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int ELL_WIN = 64;  // entries of a row in shared memory at once
constexpr uint32_t ELL_PIECE = 16384;  // bytes of X a bulk copy moves
constexpr int BSR_MAX = 64;         // the largest block edge
constexpr int BSR_MAX_WARPS = 8;    // warps a CTA
constexpr int BSR_STAGES = 4;       // a warp's ring: 3 blocks in flight
constexpr int SMEM_PER_CTA = 232448;

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

// ---------------------------------------------------------------------------
// spmm_bsr

struct BsrArgs {
  const float* values;  // (nblocks, bs, bs)
  const int* cols;      // (nblocks,)
  const int* rowp;      // (nbrows + 1,)
  const float* x;       // (n, k)
  float* y;             // (nbrows * bs, k)
  int nbrows, bs, k;
  int panel;         // columns of X a unit spans (the last may be narrower)
  int lc_log2;       // log2 of the lanes across the panel, 2 columns each
  int warps;         // warps a CTA
  int vs, xs;        // floats per staged row of a block / of X's strip
  int vals_floats;   // floats of a stage's block (a multiple of 4)
  int stage_floats;  // floats of a stage: the block, then X's strip
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's cp.async groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A lane's share of a copy of `rows` rows of q pieces each (16 bytes with
// VEC, else 4): pieces lane, lane + 32, ..., walked as (row, piece) pairs
// without a division a piece.
struct Pieces {
  int r0, u0, dr, du, q;
};

__device__ __forceinline__ Pieces pieces_of(int q, int lane) {
  return {lane / q, lane % q, 32 / q, 32 % q, q};
}

template <bool VEC>
__device__ __forceinline__ void copy_rows(float* dst, int dstride,
                                          const float* src, size_t sstride,
                                          int rows, const Pieces& p) {
  constexpr int W = VEC ? 4 : 1;
  for (int r = p.r0, u = p.u0; r < rows;) {
    if constexpr (VEC)
      cp_async16(dst + r * dstride + W * u, src + r * sstride + W * u);
    else
      cp_async4(dst + r * dstride + u, src + r * sstride + u);
    r += p.dr;
    u += p.du;
    if (u >= p.q) {
      u -= p.q;
      ++r;
    }
  }
}

// RPL: rows of the output tile a lane owns (rows lr, lr + lrs, ...; a
// power of two, at least ceil(bs / lrs)); VEC: 16-byte copies and float4
// reads of a block's rows.
template <int RPL, bool VEC>
__global__ void __launch_bounds__(BSR_MAX_WARPS * 32)
    spmm_bsr_kernel(const BsrArgs a) {
  extern __shared__ __align__(16) float bsm[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int bs = a.bs;
  const int brow = blockIdx.x;
  const int p0 = blockIdx.y * a.panel;
  const int pw = min(a.panel, a.k - p0);
  const size_t ring_floats = (size_t)BSR_STAGES * a.stage_floats;
  float* ring = bsm + warp * ring_floats;

  // the warp's range [lo, lo + nblk) of the block-row's blocks: the row
  // cut evenly over the CTA's warps, in order
  const int start = __ldg(a.rowp + brow);
  const long long len = __ldg(a.rowp + brow + 1) - start;
  const int lo = start + static_cast<int>(len * warp / a.warps);
  const int nblk = start + static_cast<int>(len * (warp + 1) / a.warps) - lo;

  // the lane's outputs: rows lr + r * lrs (read clamped into the block)
  // and columns c, c + 1 of the panel
  const int lc = lane & ((1 << a.lc_log2) - 1);
  const int lr = lane >> a.lc_log2;
  const int lrs = 32 >> a.lc_log2;
  const int c = 2 * lc;
  int vrow[RPL];
  float acc[RPL][2];
#pragma unroll
  for (int r = 0; r < RPL; ++r) {
    vrow[r] = min(lr + r * lrs, bs - 1) * a.vs;
    acc[r][0] = acc[r][1] = 0.f;
  }

  // block lo + j into stage j % BSR_STAGES (j counts up by one a call,
  // uniform over the warp); its block-column from a window of 32 of the
  // range's columns, one a lane
  constexpr int W = VEC ? 4 : 1;  // floats a copied piece
  const Pieces vp = pieces_of(bs / W, lane), xp = pieces_of(pw / W, lane);
  int cwin = 0, cbase = -32;
  auto issue = [&](int j) {
    if (j >= nblk) return;
    if (j - cbase >= 32) {
      cbase = j;
      cwin = j + lane < nblk ? __ldg(a.cols + lo + j + lane) : 0;
    }
    const int col = __shfl_sync(FULL, cwin, j - cbase);
    float* vs = ring + (j % BSR_STAGES) * a.stage_floats;
    copy_rows<VEC>(vs, a.vs, a.values + (size_t)(lo + j) * bs * bs, bs, bs,
                   vp);
    copy_rows<VEC>(vs + a.vals_floats, a.xs,
                   a.x + (size_t)col * bs * a.k + p0, a.k, bs, xp);
  };

  // one cp.async group a block (empty past the range), so that waiting for
  // all but the newest BSR_STAGES - 1 groups waits for block j alone
#pragma unroll
  for (int j = 0; j < BSR_STAGES - 1; ++j) {
    issue(j);
    cp_async_commit();
  }
  const int cx = min(c, a.xs - 2);  // the lane's columns, read in bounds
  for (int j = 0; j < nblk; ++j) {
    issue(j + BSR_STAGES - 1);
    cp_async_commit();
    cp_async_wait<BSR_STAGES - 1>();
    __syncwarp();  // every lane's pieces of block j have landed
    const float* vs = ring + (j % BSR_STAGES) * a.stage_floats;
    const float* xs = vs + a.vals_floats + cx;
    if constexpr (VEC) {
      for (int t = 0; t < bs; t += 4) {
        float2 xv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          xv[u] = *reinterpret_cast<const float2*>(xs + (t + u) * a.xs);
#pragma unroll
        for (int r = 0; r < RPL; ++r) {
          const float4 v = *reinterpret_cast<const float4*>(vs + vrow[r] + t);
          acc[r][0] = fmaf(v.x, xv[0].x, acc[r][0]);
          acc[r][1] = fmaf(v.x, xv[0].y, acc[r][1]);
          acc[r][0] = fmaf(v.y, xv[1].x, acc[r][0]);
          acc[r][1] = fmaf(v.y, xv[1].y, acc[r][1]);
          acc[r][0] = fmaf(v.z, xv[2].x, acc[r][0]);
          acc[r][1] = fmaf(v.z, xv[2].y, acc[r][1]);
          acc[r][0] = fmaf(v.w, xv[3].x, acc[r][0]);
          acc[r][1] = fmaf(v.w, xv[3].y, acc[r][1]);
        }
      }
    } else {
      for (int t = 0; t < bs; ++t) {
        const float2 xv = *reinterpret_cast<const float2*>(xs + t * a.xs);
#pragma unroll
        for (int r = 0; r < RPL; ++r) {
          const float v = vs[vrow[r] + t];
          acc[r][0] = fmaf(v, xv.x, acc[r][0]);
          acc[r][1] = fmaf(v, xv.y, acc[r][1]);
        }
      }
    }
    __syncwarp();  // the warp is done with block j's stage
  }
  cp_async_wait<0>();
  __syncwarp();

  // the warp's partial, (bs, pw) row-major, at the start of its ring; then
  // the CTA's sum, warp by warp in order, into y
#pragma unroll
  for (int r = 0; r < RPL; ++r) {
    const int i = lr + r * lrs;
    if (i < bs && c < pw) ring[i * pw + c] = acc[r][0];
    if (i < bs && c + 1 < pw) ring[i * pw + c + 1] = acc[r][1];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < bs * pw; e += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < a.warps; ++w) s += bsm[w * ring_floats + e];
    const int i = e / pw;
    a.y[((size_t)brow * bs + i) * a.k + p0 + (e - i * pw)] = s;
  }
}

template <int RPL, bool VEC>
int launch_bsr(const BsrArgs& a, size_t bytes, cudaStream_t stream) {
  const dim3 grid(a.nbrows, (a.k + a.panel - 1) / a.panel);
  auto kernel = spmm_bsr_kernel<RPL, VEC>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, a.warps * 32, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool VEC>
int launch_bsr_rows(const BsrArgs& a, int rpl, size_t bytes,
                    cudaStream_t stream) {
  switch (rpl) {
    case 1:
      return launch_bsr<1, VEC>(a, bytes, stream);
    case 2:
      return launch_bsr<2, VEC>(a, bytes, stream);
    case 4:
      return launch_bsr<4, VEC>(a, bytes, stream);
    case 8:
      return launch_bsr<8, VEC>(a, bytes, stream);
    case 16:
      return launch_bsr<16, VEC>(a, bytes, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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

// The cut comes from kernels/spmm.py bsr_partition: panel (columns of X,
// at most k and 2 * lanes_c), lanes_c (lanes across the panel, a power of
// two up to 32, 2 columns each), rpl (rows a lane owns: 1, 2, 4, 8 or 16)
// and warps (1..8).  The stage layout is worked out here alone, and the CTA
// takes as many of the warps as its stages fit in shared memory (at least
// one).
extern "C" int spmm_bsr_launch(const void* values, const void* cols,
                               const void* rowp, const void* x, void* y,
                               int nbrows, int bs, int k, int panel,
                               int lanes_c, int rpl, int warps,
                               void* stream) {
  int lc_log2 = 0;
  while (lc_log2 < 5 && (1 << lc_log2) < lanes_c) ++lc_log2;
  if (bs < 1 || bs > BSR_MAX || k < 1 || nbrows < 1 || panel < 1 ||
      panel > k || (1 << lc_log2) != lanes_c || 2 * lanes_c < panel ||
      rpl * (32 >> lc_log2) < bs || warps < 1 || warps > BSR_MAX_WARPS)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = bs % 4 == 0 && k % 4 == 0 && panel % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(values) |
                    reinterpret_cast<uintptr_t>(x)) % 16 == 0;
  BsrArgs a{static_cast<const float*>(values), static_cast<const int*>(cols),
            static_cast<const int*>(rowp), static_cast<const float*>(x),
            static_cast<float*>(y), nbrows, bs, k, panel, lc_log2, warps,
            0, 0, 0, 0};
  // row strides: a float4 read (vec) or a float read of the lanes' rows
  // lands on distinct banks (vs / 4 odd, or vs odd); X's rows hold the
  // panel (rounded up to the float2 a lane reads)
  a.vs = vec ? ((bs / 4) % 2 ? bs : bs + 4) : (bs | 1);
  a.xs = vec ? panel : panel + (panel & 1);
  a.vals_floats = (bs * a.vs + 3) & ~3;
  a.stage_floats = a.vals_floats + ((bs * a.xs + 3) & ~3);
  const size_t ring = sizeof(float) * BSR_STAGES * a.stage_floats;
  const size_t fit = SMEM_PER_CTA / ring;
  if (fit < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (fit < static_cast<size_t>(warps)) a.warps = static_cast<int>(fit);
  const size_t bytes = ring * a.warps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? launch_bsr_rows<true>(a, rpl, bytes, s)
             : launch_bsr_rows<false>(a, rpl, bytes, s);
}
