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
// which reads each diagonal's shifted window of a zero-padded x as a static
// slice.  Here one thread owns one output row and loops over the diagonals,
// whose offsets arrive as a small int32 device array; a read outside [0, n)
// gives 0, which replaces the padded copy of x.  Reads of diags[d][i] are
// coalesced across the threads of a warp.  Bound: bytes (the band's values
// plus x and y); at n = 1024 this launch holds only 1024 threads, so it is
// latency-bound long before it reaches that.
#include <cuda_runtime.h>

namespace {

constexpr int ELL_THREADS = 256;  // 8 rows per block
constexpr int DIA_THREADS = 128;

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

__global__ void __launch_bounds__(DIA_THREADS)
    spmv_dia_kernel(const float* __restrict__ diags,
                    const int* __restrict__ offsets,
                    const float* __restrict__ x, float* __restrict__ y, int n,
                    int ndiags) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int d = 0; d < ndiags; ++d) {
    const int j = i + __ldg(offsets + d);
    const float xv = (j >= 0 && j < n) ? __ldg(x + j) : 0.f;
    acc = fmaf(diags[(size_t)d * n + i], xv, acc);
  }
  y[i] = acc;
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

extern "C" int spmv_dia_launch(const void* diags, const void* offsets,
                               const void* x, void* y, int n, int ndiags,
                               void* stream) {
  const int blocks = (n + DIA_THREADS - 1) / DIA_THREADS;
  spmv_dia_kernel<<<blocks, DIA_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(diags), static_cast<const int*>(offsets),
      static_cast<const float*>(x), static_cast<float*>(y), n, ndiags);
  return static_cast<int>(cudaGetLastError());
}
