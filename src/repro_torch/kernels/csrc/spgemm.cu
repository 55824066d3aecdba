// SpGEMM numeric phase: BSR x BSR block products into a precomputed output
// pattern, in CUDA for sm_90a.  f32 values, int32 indices, f32 sums.
//
// spgemm_bsr_kernel replaces the Pallas TPU kernel
// src/repro/kernels/spgemm.py:45 (spgemm_bsr_kernel): Gustavson's row-wise
// form at block granularity.  For each output block-row i it walks A's
// live blocks p (inner block-column k = a_cols[p]) and B's block-row k,
// and accumulates a_vals[p] @ b_vals[q] into output tile (i, b_cols[q]).
// The Pallas kernel keeps a dense (bs, ncols) f32 row accumulator in VMEM;
// in shared memory that is bs * ncols * 4 bytes, 64 KB at bs 8 and
// ncols 2048 and 256 KB at bs 32, above what a CTA can have (227 KB).  So
// this kernel accumulates straight into the output's live tiles instead:
//
//   one CTA per output block-row i (256 threads)
//     zero the row's slots c_vals[c_rowp[i] .. c_rowp[i+1])
//     for p in a_rowp[i] .. a_rowp[i+1]:          (serial, a barrier each)
//       stage a_vals[p] in shared memory
//       for q in b_rowp[k] .. b_rowp[k+1]:        (256 / bs pairs at once)
//         slot = binary search of b_cols[q] in the row's sorted c_cols
//         c_vals[slot] += a_vals[p] @ b_vals[q]   (bs threads, a row each)
//
// A pair whose tile is not in the row's pattern (a plan that is not the
// symbolic phase's for these operands) sets *err and is skipped; the
// wrapper reads *err after the launch and raises.
//
// Every slot belongs to one CTA, so no atomics are needed.  Within one p
// the q of B's row k name distinct block-columns, hence distinct slots, so
// the 256 / bs groups of a CTA update disjoint tiles; the barrier between
// two p orders the updates of one slot.  A thread owns one row of the
// bs x bs product: it holds that row of a_vals[p] and the row's bs sums in
// registers and reads b_vals[q] through the read-only cache (all threads
// of a group read the same element at once, a broadcast).  The per-pair
// sums run over t in order, then add to the slot in p order: the order the
// plain pair formulation (kernels/spgemm.py) uses.
//
// Bound on this card: operations, 2 * npairs * bs^3 f32 FMA work against
// the bytes of a_vals + b_vals + c_vals.  At the SpGEMM suite's clustered
// 0.2 case (n = 2048, bs 8: about 672 k pairs, 688 MFLOP, 65.5 k output
// tiles) the bound is about 10 us; this kernel is latency-bound well above
// it: 256 CTAs (two per SM at most), a serial walk over A's row with a
// barrier per block, and a read-modify-write of the output tile per pair.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ int find_slot(const int* __restrict__ c_cols,
                                         int lo, int hi, int j) {
  int l = lo, h = hi;
  while (l < h) {
    const int m = (l + h) >> 1;
    if (__ldg(c_cols + m) < j)
      l = m + 1;
    else
      h = m;
  }
  return (l < hi && __ldg(c_cols + l) == j) ? l : -1;
}

template <int BS>
__global__ void __launch_bounds__(THREADS)
    spgemm_bsr_kernel(const float* __restrict__ a_vals,
                      const int* __restrict__ a_cols,
                      const int* __restrict__ a_rowp,
                      const float* __restrict__ b_vals,
                      const int* __restrict__ b_cols,
                      const int* __restrict__ b_rowp,
                      const int* __restrict__ c_cols,
                      const int* __restrict__ c_rowp,
                      float* __restrict__ c_vals, int* __restrict__ err) {
  constexpr int TILE = BS * BS;
  constexpr int GROUPS = THREADS / BS;  // pairs in flight per CTA
  __shared__ float a_s[BS][BS + 1];     // +1: a thread per row, no conflicts
  const int i = blockIdx.x;
  const int c_lo = __ldg(c_rowp + i);
  const int c_hi = __ldg(c_rowp + i + 1);
  float* row_out = c_vals + (size_t)c_lo * TILE;
  const size_t row_len = (size_t)(c_hi - c_lo) * TILE;
  for (size_t e = threadIdx.x; e < row_len; e += THREADS) row_out[e] = 0.f;

  const int g = threadIdx.x / BS;  // which pair of the round
  const int r = threadIdx.x % BS;  // which row of the tile
  const int p_hi = __ldg(a_rowp + i + 1);
  for (int p = __ldg(a_rowp + i); p < p_hi; ++p) {
    __syncthreads();  // zeroing, or the previous p's updates, are done
    for (int e = threadIdx.x; e < TILE; e += THREADS)
      a_s[e / BS][e % BS] = __ldg(a_vals + (size_t)p * TILE + e);
    __syncthreads();
    float a_row[BS];
#pragma unroll
    for (int t = 0; t < BS; ++t) a_row[t] = a_s[r][t];
    const int kk = __ldg(a_cols + p);
    const int q_hi = __ldg(b_rowp + kk + 1);
    for (int q = __ldg(b_rowp + kk) + g; q < q_hi; q += GROUPS) {
      const int slot = find_slot(c_cols, c_lo, c_hi, __ldg(b_cols + q));
      if (slot < 0) {  // not in the pattern: the wrapper raises
        *err = 1;
        continue;
      }
      const float* bq = b_vals + (size_t)q * TILE;
      float acc[BS];
#pragma unroll
      for (int c = 0; c < BS; ++c) acc[c] = 0.f;
#pragma unroll
      for (int t = 0; t < BS; ++t) {
#pragma unroll
        for (int c = 0; c < BS; ++c)
          acc[c] = fmaf(a_row[t], __ldg(bq + t * BS + c), acc[c]);
      }
      float* out = c_vals + (size_t)slot * TILE + r * BS;
#pragma unroll
      for (int c = 0; c < BS; ++c) out[c] += acc[c];
    }
  }
}

template <int BS>
int launch(const void* a_vals, const void* a_cols, const void* a_rowp,
           const void* b_vals, const void* b_cols, const void* b_rowp,
           const void* c_cols, const void* c_rowp, void* c_vals, void* err,
           int nbrows, cudaStream_t stream) {
  spgemm_bsr_kernel<BS><<<nbrows, THREADS, 0, stream>>>(
      static_cast<const float*>(a_vals), static_cast<const int*>(a_cols),
      static_cast<const int*>(a_rowp), static_cast<const float*>(b_vals),
      static_cast<const int*>(b_cols), static_cast<const int*>(b_rowp),
      static_cast<const int*>(c_cols), static_cast<const int*>(c_rowp),
      static_cast<float*>(c_vals), static_cast<int*>(err));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int spgemm_bsr_launch(const void* a_vals, const void* a_cols,
                                 const void* a_rowp, const void* b_vals,
                                 const void* b_cols, const void* b_rowp,
                                 const void* c_cols, const void* c_rowp,
                                 void* c_vals, void* err, int nbrows, int bs,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bs) {
    case 8:
      return launch<8>(a_vals, a_cols, a_rowp, b_vals, b_cols, b_rowp,
                       c_cols, c_rowp, c_vals, err, nbrows, s);
    case 16:
      return launch<16>(a_vals, a_cols, a_rowp, b_vals, b_cols, b_rowp,
                        c_cols, c_rowp, c_vals, err, nbrows, s);
    case 32:
      return launch<32>(a_vals, a_cols, a_rowp, b_vals, b_cols, b_rowp,
                        c_cols, c_rowp, c_vals, err, nbrows, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
