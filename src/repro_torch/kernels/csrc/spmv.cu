// Sparse matrix-vector products for mod2as (ELL) and banded systems (DIA),
// in CUDA for sm_90a.
//
// spmv_ell_kernel replaces the Pallas TPU kernel
// src/repro/kernels/spmv.py:42 (spmv_ell_kernel), which walks (row block,
// width block) tiles with x resident in VMEM and gathers x[cols] inside the
// tile.  Here one warp owns one row: its 32 lanes read consecutive ELL
// entries of the row (coalesced), gather x through the read-only path, and
// reduce with warp shuffles.  Padding entries (value 0, column 0, as
// ell_from_csr writes them) add 0.
//
// Bound on this card: bytes.  At the paper's largest Table-1 input
// (n = 10240, 5.72 % fill, about 6.0 M nonzeros) the product must read
// 8 bytes per stored nonzero (value + column), about 48 MB, so 3.35 TB/s
// bounds it near 14 us.  x (40 KB) stays in L1/L2.  The ELL padding above
// the CSR nonzeros is read too; it is about 10 % at that fill.
//
// spmv_dia_kernel replaces src/repro/kernels/spmv.py:88 (spmv_dia_kernel),
// which reads each diagonal's shifted window of a zero-padded x (xpad) as a
// static slice.  Bound on this card: bytes, the live band (each diagonal's
// rows [max(0, -o), min(n, n - o)); dia_from_dense stores zeros outside it)
// plus x and y: at CG conf 18 (n = 1024, 1023 diagonals) 3.15 MB, 0.94 us
// at 3.35 TB/s.  So small a product is latency-bound unless most of it is
// in flight at once, and one thread per row (8 CTAs, a chain of 1023
// dependent loads each) was far from that.  Here the work is cut two ways,
// into tiles of consecutive rows and chunks of consecutive diagonals
// (kernels/spmv.py dia_partition sizes both from n, the diagonal count and
// the SM count: a tridiagonal system at large n runs many row tiles and one
// chunk; the conf-18 band a few row tiles and many chunks).  A CTA of 256
// threads owns one (tile, chunk): thread (g, q) owns rows 4g .. 4g + 3 of
// the tile and walks diagonals q, q + dw, ... of the chunk (dw = 256 * 4 /
// tile rows), with one 16-byte load of diags[d][4g ..] each (coalesced
// across the warp; 4-byte loads when n % 4 != 0) into four independent
// accumulators; a group of 4 rows wholly outside a diagonal's live range is
// skipped.  The chunk's window of x (the tile's rows shifted by the chunk's
// offsets), zero outside [0, n), is staged in shared memory first: xpad,
// made per CTA, so the inner loop has no bounds test.  The dw partial sums
// of a row meet in shared memory in a fixed order.  With one chunk the CTA
// writes y; with several it writes its partial to a (chunks, n) scratch,
// and the last CTA of the row tile to arrive (an integer ticket per tile,
// reset by that CTA) adds the tile's partials in a fixed order and writes
// y.  No float atomics: y is bitwise the same from run to run.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int ELL_THREADS = 256;  // 8 rows per block
constexpr int DIA_THREADS = 256;  // 4 rows a thread, tiles of 1024 / dw rows
constexpr int DIA_NACC = 4;       // independent accumulators per thread

__global__ void __launch_bounds__(ELL_THREADS)
    spmv_ell_kernel(const float* __restrict__ values,
                    const int* __restrict__ cols, const float* __restrict__ x,
                    float* __restrict__ y, int nrows, int width) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= nrows) return;  // uniform across the warp
  const float* v = values + (size_t)row * width;
  const int* c = cols + (size_t)row * width;
  float acc = 0.f;
  for (int w = lane; w < width; w += 32) acc = fmaf(v[w], __ldg(x + c[w]), acc);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  if (lane == 0) y[row] = acc;
}

struct DiaArgs {
  const float* diags;  // (ndiags, n)
  const int* offsets;  // (ndiags,)
  const float* x;
  float* y;
  float* partial;  // (nchunks, n), or null when nchunks == 1
  int* tickets;    // (row tiles,), 0 between launches
  int n, ndiags;
  int dw;         // threads per row group (diagonal lanes); rows = 1024 / dw
  int per_chunk;  // diagonals per chunk (the last may hold fewer)
  int nchunks;
  int window;  // floats of x the dynamic shared memory holds; 0: read x
               // from global memory with a bounds test
};

__device__ __forceinline__ float4 operator+(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// rows i0 .. i0 + 3 of `p` (row stride 1), as one 16-byte load or four
// 4-byte ones with rows at or past n reading 0; `cg` reads through L2 only
// (data another CTA of this launch wrote)
template <bool VEC4, bool CG = false>
__device__ __forceinline__ float4 load4(const float* p, int i0, int n) {
  if (VEC4)
    return CG ? __ldcg(reinterpret_cast<const float4*>(p + i0))
              : __ldg(reinterpret_cast<const float4*>(p + i0));
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    v[k] = i0 + k < n ? (CG ? __ldcg(p + i0 + k) : __ldg(p + i0 + k)) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

template <bool VEC4>
__device__ __forceinline__ void store4(float* p, int i0, int n, float4 v) {
  if (VEC4) {
    *reinterpret_cast<float4*>(p + i0) = v;
    return;
  }
  const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (i0 + k < n) p[i0 + k] = w[k];
}

// acc += diags[d][i0 .. i0 + 3] * x[i0 + o .. i0 + o + 3]; x from the staged
// window xs (which starts at x index base) or from global memory
template <bool VEC4, bool STAGED>
__device__ __forceinline__ void dia_fma(const DiaArgs& a, const float* xs,
                                        int base, int i0, int d,
                                        float4& acc) {
  const int o = __ldg(a.offsets + d);
  if (i0 + 4 <= -o || i0 >= a.n - o) return;  // no live row: stored zeros
  const float4 v = load4<VEC4>(a.diags + (size_t)d * a.n, i0, a.n);
  const int j = i0 + o;
  float xv[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    xv[k] = STAGED ? xs[j + k - base]
                   : ((unsigned)(j + k) < (unsigned)a.n ? __ldg(a.x + j + k)
                                                        : 0.f);
  acc.x = fmaf(v.x, xv[0], acc.x);
  acc.y = fmaf(v.y, xv[1], acc.y);
  acc.z = fmaf(v.z, xv[2], acc.z);
  acc.w = fmaf(v.w, xv[3], acc.w);
}

// the thread's diagonals d0, d0 + step, ... below d1 into NACC accumulators
// (diagonal u of each group of NACC into accumulator u), summed
// (acc0 + acc1) + (acc2 + acc3)
template <bool VEC4, bool STAGED>
__device__ __forceinline__ float4 dia_walk(const DiaArgs& a, const float* xs,
                                           int base, int i0, int d0, int d1,
                                           int step) {
  float4 acc[DIA_NACC];
#pragma unroll
  for (int u = 0; u < DIA_NACC; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int d = d0; d < d1; d += DIA_NACC * step) {
#pragma unroll
    for (int u = 0; u < DIA_NACC; ++u)
      if (d + u * step < d1)
        dia_fma<VEC4, STAGED>(a, xs, base, i0, d + u * step, acc[u]);
  }
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// Sum v over the dw threads of each row group, q = 0 first: every thread
// writes its 4 rows, the threads with q == 0 read the sums.
__device__ __forceinline__ float4 dia_combine(float4 v, int g, int q,
                                              int rows, int dw,
                                              float4* part) {
  part[q * (rows / 4) + g] = v;
  __syncthreads();
  float4 s = part[g];
  if (q == 0)
    for (int r = 1; r < dw; ++r) s = s + part[r * (rows / 4) + g];
  return s;
}

template <bool VEC4>
__global__ void __launch_bounds__(DIA_THREADS)
    spmv_dia_kernel(DiaArgs a) {
  extern __shared__ float xs[];  // the chunk's window of x (a.window floats)
  __shared__ float4 part[DIA_THREADS];
  __shared__ int red[2 * DIA_THREADS / 32];
  __shared__ int ticket;

  const int groups = DIA_THREADS / a.dw;  // row groups of 4 in a tile
  const int rows = 4 * groups;
  const int g = threadIdx.x % groups;
  const int q = threadIdx.x / groups;
  const int r0 = blockIdx.x * rows;
  const int i0 = r0 + 4 * g;
  const int d0 = blockIdx.y * a.per_chunk;
  const int d1 = min(d0 + a.per_chunk, a.ndiags);

  // the chunk's smallest and largest offset
  int lo = INT_MAX, hi = INT_MIN;
  for (int d = d0 + threadIdx.x; d < d1; d += DIA_THREADS) {
    const int o = __ldg(a.offsets + d);
    lo = min(lo, o);
    hi = max(hi, o);
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, s));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, s));
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    red[warp] = lo;
    red[DIA_THREADS / 32 + warp] = hi;
  }
  __syncthreads();
  lo = red[0];
  hi = red[DIA_THREADS / 32];
  for (int w = 1; w < DIA_THREADS / 32; ++w) {
    lo = min(lo, red[w]);
    hi = max(hi, red[DIA_THREADS / 32 + w]);
  }
  if (hi < lo) lo = hi = 0;  // an empty chunk (no diagonals at all)

  // xpad for this CTA: x[base .. base + len), zero outside [0, n)
  const int base = r0 + lo;
  const int len = rows + (hi - lo);
  const bool staged = len <= a.window;  // uniform over the CTA
  if (staged)
    for (int e = threadIdx.x; e < len; e += DIA_THREADS) {
      const int j = base + e;
      xs[e] = (unsigned)j < (unsigned)a.n ? __ldg(a.x + j) : 0.f;
    }
  __syncthreads();

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i0 < a.n)
    acc = staged ? dia_walk<VEC4, true>(a, xs, base, i0, d0 + q, d1, a.dw)
                 : dia_walk<VEC4, false>(a, xs, base, i0, d0 + q, d1, a.dw);
  acc = dia_combine(acc, g, q, rows, a.dw, part);
  const bool writer = q == 0 && i0 < a.n;
  if (a.nchunks == 1) {
    if (writer) store4<VEC4>(a.y, i0, a.n, acc);
    return;
  }

  // several chunks: publish this chunk's partial; the tile's last CTA sums
  if (writer)
    store4<VEC4>(a.partial + (size_t)blockIdx.y * a.n, i0, a.n, acc);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) ticket = atomicAdd(a.tickets + blockIdx.x, 1);
  __syncthreads();
  if (ticket != a.nchunks - 1) return;
  __threadfence();
  // chunks q, q + dw, ... in order per thread, then the dw sums in order
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i0 < a.n)
    for (int c = q; c < a.nchunks; c += a.dw)
      s = s + load4<VEC4, true>(a.partial + (size_t)c * a.n, i0, a.n);
  __syncthreads();  // part is free again
  s = dia_combine(s, g, q, rows, a.dw, part);
  if (writer) store4<VEC4>(a.y, i0, a.n, s);
  if (threadIdx.x == 0) a.tickets[blockIdx.x] = 0;  // for the next launch
}

}  // namespace

extern "C" int spmv_ell_launch(const void* values, const void* cols,
                               const void* x, void* y, int nrows, int width,
                               void* stream) {
  const int rows_per_block = ELL_THREADS / 32;
  const int blocks = (nrows + rows_per_block - 1) / rows_per_block;
  spmv_ell_kernel<<<blocks, ELL_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), static_cast<const int*>(cols),
      static_cast<const float*>(x), static_cast<float*>(y), nrows, width);
  return static_cast<int>(cudaGetLastError());
}

// diags (ndiags, n) f32, offsets (ndiags,) int32, x and y (n,) f32 on the
// card; partial (nchunks, n) f32 scratch when nchunks > 1, tickets (n_tiles,)
// int32, all 0, reset to 0 by the launch.  The partition (dw diagonal lanes
// per row group, tiles of 1024 / dw rows, per_chunk diagonals a chunk) and
// the window (floats of x a CTA stages; 0 for none) come from
// kernels/spmv.py dia_partition / dia_window.
extern "C" int spmv_dia_launch(const void* diags, const void* offsets,
                               const void* x, void* y, void* partial,
                               void* tickets, int n, int ndiags, int dw,
                               int per_chunk, int nchunks, int window,
                               void* stream) {
  if (dw < 1 || dw > 8 || (dw & (dw - 1)) || per_chunk < 1 || nchunks < 1 ||
      nchunks > 65535 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const DiaArgs a{static_cast<const float*>(diags),
                  static_cast<const int*>(offsets),
                  static_cast<const float*>(x),
                  static_cast<float*>(y),
                  static_cast<float*>(partial),
                  static_cast<int*>(tickets),
                  n, ndiags, dw, per_chunk, nchunks, window};
  const int rows = 4 * DIA_THREADS / dw;
  const dim3 grid((n + rows - 1) / rows, nchunks);
  const size_t bytes = sizeof(float) * (size_t)window;
  const bool vec4 = n % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(diags) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(partial) % 16 == 0;
  auto kernel = vec4 ? spmv_dia_kernel<true> : spmv_dia_kernel<false>;
  cudaError_t err = cudaSuccess;
  if (bytes > 48 * 1024)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, DIA_THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
