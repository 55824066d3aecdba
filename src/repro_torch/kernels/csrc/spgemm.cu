// SpGEMM numeric phase: BSR x BSR block products into a precomputed output
// pattern, in CUDA for sm_90a.  f32 values, int32 indices, f32 sums.
//
// spgemm_bsr_kernel replaces the Pallas TPU kernel
// src/repro/kernels/spgemm.py:45 (spgemm_bsr_kernel): Gustavson's row-wise
// form at block granularity.  For each output block-row i it walks A's
// live blocks p (inner block-column k = a_cols[p]) and B's block-row k,
// and accumulates a_vals[p] @ b_vals[q] into output tile (i, b_cols[q]).
// The Pallas kernel keeps a dense (bs, ncols) f32 row accumulator in VMEM.
// Here that row is cut into ranges of `span` block-columns
// (kernels/spgemm.py spgemm_span: 4 KB of accumulator, 16 block-columns at
// bs 8, one at bs 32 and 64), and each range is one warp's, with its dense
// accumulator in shared memory:
//
//   CTA = (block-row i, 4 consecutive ranges), a warp per range
//     the range's live slots of C (a search of c_cols) -> a slot table
//       and a presence mask
//     for A's blocks p of row i, 32 at a time:
//       lane t finds the sub-run of B's row a_cols[p + t] that falls in
//         the range (a binary search, then at most span independent
//         loads; all 32 lanes' searches in flight at once)
//       for each p in order: the lanes share out the run's (tile, 2 rows,
//         4 columns) units; each adds a_vals[p] @ b_vals[q] (its rows and
//         columns, a sum over t in order, read through the read-only
//         cache as 16-byte loads) into its part of the accumulator;
//         __syncwarp between two p
//     write the range's live slots of C once
//
// The warps never wait for each other: a warp owns its range's
// accumulator, so nothing is shared and no atomics are needed.  Within
// one p the run's tiles are distinct block-columns, so no two lanes touch
// one element; between two p the warp synchronises.  Every output element
// gets its pair products in p order, each a sum over t in order: the order
// the plain pair formulation (kernels/spgemm.py) uses, bitwise the same
// from run to run.  A pair whose block-column has no slot in the pattern
// (a plan that is not the symbolic phase's for these operands) sets *err
// and is skipped; the wrapper reads *err after the launch and raises.
// Block edges 8, 16, 32 and 64 are compiled in (16-byte loads, 16-byte
// aligned values); any other edge up to 64, or values not 16-byte aligned,
// run the same kernel with bs as an argument and 4-byte loads.
//
// Bound on this card: operations, 2 * npairs * bs^3 f32 FMA work against
// the bytes of a_vals + b_vals + c_vals.  At the SpGEMM suite's clustered
// 0.2 case (n = 2048, bs 8: about 672 k pairs, 688 MFLOP, 65.5 k output
// tiles) the bound is about 10 us.  This design is held above it by L2:
// every pair reads its B tile through L2 (172 MB a call there, and each
// warp reads its row's A tiles again), and each of the 4096 warps (one
// wave on 132 SMs) is a chain of one L2 round trip per block of A's row
// (about 51) after its searches.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;    // ranges (warps) per CTA
constexpr int MAX_BS = 64;  // the largest block edge

struct SpgemmArgs {
  const float* a_vals;
  const int* a_cols;
  const int* a_rowp;
  const float* b_vals;
  const int* b_cols;
  const int* b_rowp;
  const int* c_cols;
  const int* c_rowp;
  float* c_vals;
  int* err;
  int bs, nbcols, span;
};

// First index in [lo, hi) whose value is >= key (hi if none).
__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int lo,
                                           int hi, int key) {
  while (lo < hi) {
    const int m = (lo + hi) >> 1;
    if (__ldg(a + m) < key)
      lo = m + 1;
    else
      hi = m;
  }
  return lo;
}

// BS > 0: a compiled edge, 4 columns a unit; BS == 0: g.bs, 1 column.
template <int BS>
__global__ void __launch_bounds__(WARPS * 32, 8)
    spgemm_bsr_kernel(const SpgemmArgs g) {
  constexpr int V = BS ? 4 : 1;   // columns a unit
  constexpr int RU = BS ? 2 : 1;  // rows a unit
  const int bs = BS ? BS : g.bs;
  const int tile = bs * bs;
  const int upr = bs / V;             // units across a tile
  const int upt = bs / RU * upr;      // units per tile
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int span = g.span;
  const int i = blockIdx.x;
  const int jw0 = (blockIdx.y * WARPS + warp) * span;
  if (jw0 >= g.nbcols) return;  // no CTA-wide barrier follows
  const int jw1 = min(jw0 + span, g.nbcols);
  extern __shared__ __align__(16) float sgm[];
  float* acc = sgm + (size_t)warp * span * tile;
  int* slot_of = reinterpret_cast<int*>(sgm + (size_t)WARPS * span * tile) +
                 warp * span;

  // the range's live slots (at most span <= 32 of them, one a lane)
  const int c_lo = __ldg(g.c_rowp + i);
  const int c_hi = __ldg(g.c_rowp + i + 1);
  const int s = lower_bound(g.c_cols, c_lo, c_hi, jw0) + lane;
  const int col = s < c_hi ? __ldg(g.c_cols + s) : jw1;
  const bool live = col < jw1;
  if (lane < span) slot_of[lane] = -1;
  __syncwarp();
  if (live) slot_of[col - jw0] = s;
  const unsigned present =
      __reduce_or_sync(FULL, live ? 1u << (col - jw0) : 0u);
  for (int e = lane * V; e < span * tile; e += 32 * V) {
    if constexpr (V == 4)
      *reinterpret_cast<float4*>(acc + e) = make_float4(0.f, 0.f, 0.f, 0.f);
    else
      acc[e] = 0.f;
  }
  __syncwarp();

  const int a_lo = __ldg(g.a_rowp + i);
  const int a_hi = __ldg(g.a_rowp + i + 1);
  for (int pc = a_lo; pc < a_hi; pc += 32) {
    const int p = pc + lane;
    int lo = 0, hi = 0;
    if (p < a_hi) {
      const int kk = __ldg(g.a_cols + p);
      const int r0 = __ldg(g.b_rowp + kk);
      const int r1 = __ldg(g.b_rowp + kk + 1);
      lo = lower_bound(g.b_cols, r0, r1, jw0);
      // at most span of B's columns fall in the range: count them with
      // independent loads rather than a second search
      const int top = min(r1, lo + span);
      hi = lo;
#pragma unroll 8
      for (int q = lo; q < top; ++q) hi += __ldg(g.b_cols + q) < jw1;
    }
    if (!present) {  // no slot in range: any product here is off-plan
      if (__any_sync(FULL, hi > lo) && lane == 0) *g.err = 1;
      continue;
    }
    const int cnt = min(32, a_hi - pc);
    for (int t = 0; t < cnt; ++t) {
      const int qlo = __shfl_sync(FULL, lo, t);
      const int qhi = __shfl_sync(FULL, hi, t);
      if (qlo == qhi) continue;
      const float* ap = g.a_vals + (size_t)(pc + t) * tile;
      for (int u = lane; u < (qhi - qlo) * upt; u += 32) {
        const int h = u / upt;
        const int e = u - h * upt;
        const int r = e / upr * RU;
        const int c = (e - e / upr * upr) * V;
        const int q = qlo + h;
        // the tile's column, checked after the product so that the
        // product's loads need not wait for it
        const int jj = __ldg(g.b_cols + q) - jw0;
        const float* ar = ap + r * bs;
        const float* bq = g.b_vals + (size_t)q * tile + c;
        if constexpr (V == 4) {  // rows r, r + 1 x columns c .. c + 3
          float sum[RU][V] = {};
          constexpr int UNROLL = BS <= 16 ? BS / 4 : 4;
#pragma unroll UNROLL
          for (int t4 = 0; t4 < BS; t4 += 4) {
            float av[RU][4];
#pragma unroll
            for (int i2 = 0; i2 < RU; ++i2) {
              const float4 a4 = __ldg(
                  reinterpret_cast<const float4*>(ar + i2 * BS + t4));
              av[i2][0] = a4.x;
              av[i2][1] = a4.y;
              av[i2][2] = a4.z;
              av[i2][3] = a4.w;
            }
#pragma unroll
            for (int tt = 0; tt < 4; ++tt) {
              const float4 b4 = __ldg(
                  reinterpret_cast<const float4*>(bq + (t4 + tt) * BS));
#pragma unroll
              for (int i2 = 0; i2 < RU; ++i2) {
                sum[i2][0] = fmaf(av[i2][tt], b4.x, sum[i2][0]);
                sum[i2][1] = fmaf(av[i2][tt], b4.y, sum[i2][1]);
                sum[i2][2] = fmaf(av[i2][tt], b4.z, sum[i2][2]);
                sum[i2][3] = fmaf(av[i2][tt], b4.w, sum[i2][3]);
              }
            }
          }
          if (!((present >> jj) & 1u)) {
            *g.err = 1;
            continue;
          }
          float* dst = acc + jj * tile + r * bs + c;
#pragma unroll
          for (int i2 = 0; i2 < RU; ++i2) {
            float4* d4 = reinterpret_cast<float4*>(dst + i2 * BS);
            float4 d = *d4;
            d.x += sum[i2][0];
            d.y += sum[i2][1];
            d.z += sum[i2][2];
            d.w += sum[i2][3];
            *d4 = d;
          }
        } else {
          float s0 = 0.f;
          for (int tt = 0; tt < bs; ++tt)
            s0 = fmaf(__ldg(ar + tt), __ldg(bq + tt * bs), s0);
          if (!((present >> jj) & 1u)) {
            *g.err = 1;
            continue;
          }
          acc[jj * tile + r * bs + c] += s0;
        }
      }
      __syncwarp();  // p's updates land before p + 1's
    }
  }

  const int vpt = tile / V;  // vectors per tile
  for (int u = lane; u < span * vpt; u += 32) {
    const int jj = u / vpt;
    const int slot = slot_of[jj];
    if (slot < 0) continue;
    const int e = (u - jj * vpt) * V;
    if constexpr (V == 4)
      *reinterpret_cast<float4*>(g.c_vals + (size_t)slot * tile + e) =
          *reinterpret_cast<const float4*>(acc + jj * tile + e);
    else
      g.c_vals[(size_t)slot * tile + e] = acc[jj * tile + e];
  }
}

template <int BS>
int launch(const SpgemmArgs& g, int nbrows, cudaStream_t stream) {
  const int per_cta = WARPS * g.span;
  const dim3 grid(nbrows, (g.nbcols + per_cta - 1) / per_cta);
  const size_t bytes =
      (size_t)WARPS * g.span * (sizeof(float) * g.bs * g.bs + sizeof(int));
  auto kernel = spgemm_bsr_kernel<BS>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, WARPS * 32, bytes, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// span: block-columns a warp owns (1..32, kernels/spgemm.py spgemm_span).
extern "C" int spgemm_bsr_launch(const void* a_vals, const void* a_cols,
                                 const void* a_rowp, const void* b_vals,
                                 const void* b_cols, const void* b_rowp,
                                 const void* c_cols, const void* c_rowp,
                                 void* c_vals, void* err, int nbrows, int bs,
                                 int nbcols, int span, void* stream) {
  if (bs < 1 || bs > MAX_BS || span < 1 || span > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const SpgemmArgs g{static_cast<const float*>(a_vals),
                     static_cast<const int*>(a_cols),
                     static_cast<const int*>(a_rowp),
                     static_cast<const float*>(b_vals),
                     static_cast<const int*>(b_cols),
                     static_cast<const int*>(b_rowp),
                     static_cast<const int*>(c_cols),
                     static_cast<const int*>(c_rowp),
                     static_cast<float*>(c_vals),
                     static_cast<int*>(err),
                     bs, nbcols, span};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = (reinterpret_cast<uintptr_t>(a_vals) |
                        reinterpret_cast<uintptr_t>(b_vals) |
                        reinterpret_cast<uintptr_t>(c_vals)) % 16 == 0;
  if (aligned) {
    switch (bs) {
      case 8:
        return launch<8>(g, nbrows, s);
      case 16:
        return launch<16>(g, nbrows, s);
      case 32:
        return launch<32>(g, nbrows, s);
      case 64:
        return launch<64>(g, nbrows, s);
      default:
        break;
    }
  }
  return launch<0>(g, nbrows, s);
}
