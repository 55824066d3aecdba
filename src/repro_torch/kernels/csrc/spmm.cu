// SpMM: a sparse matrix times a dense multi-RHS panel X (n, k), in ELL and
// BSR layouts, in CUDA for sm_90a.  f32 values and X, int32 indices, f32
// accumulation.
//
// spmm_ell_kernel replaces the Pallas TPU kernel
// src/repro/kernels/spmm.py:41 (spmm_ell_kernel), which walks (row block,
// RHS panel, width block) tiles with the whole X panel in VMEM and gathers
// rows of it inside the tile.  Here a CTA owns a tile of rows times a panel
// of kp <= 32 columns of X: threadIdx.x runs along k, so the gathered row
// of X is read coalesced, and threadIdx.y picks the row.  Each thread walks
// its row's width serially.  Ragged nrows and k are masked in the kernel
// (the JAX path pads to 8/128/128 instead); padding entries (value 0,
// column 0, as ell_from_csr writes them) add 0 * X[0, :], as the reference
// does.
//
// spmm_bsr_kernel replaces src/repro/kernels/spmm.py:91 (spmm_bsr_kernel),
// a recorded loop over one block-row's live blocks with a (bs, bs) x
// (bs, bn) product per block.  Here a CTA owns one block-row and a panel
// of 32 columns of X.  For each live block it stages the bs x bs tile and
// the matching bs x 32 strip of X in shared memory; each thread keeps bs/8
// outputs of the (bs, 32) output tile in registers.  Ragged k is masked; a
// block-row with no live blocks writes zeros.
//
// Bound on this card.  ELL: each stored entry is read once (8 bytes) and
// drives k FMAs on a gathered row of X, which stays in L2 at the sizes of
// the main path: at mod2as n = 10240 (ELL width 675) and k = 64, 55 MB of
// entries bound it by bytes near 17 us, but every entry gathers k * 4 bytes
// of X through L1/L2, so L2 bandwidth is the practical limit.  BSR: 8 bytes
// of index per block and 4 bytes per stored value, each driving k FMAs;
// at the SpGEMM suite's clustered operand (n = 2048, bs 8, 13 k blocks)
// and k = 64 it is bytes-bound at a few microseconds and latency-bound in
// practice (one CTA per block-row and k panel, 512 CTAs).
#include <cuda_runtime.h>

namespace {

constexpr int ELL_THREADS = 256;
constexpr int BSR_THREADS = 256;
constexpr int BSR_PANEL = 32;  // columns of X per CTA (one warp wide)

__global__ void __launch_bounds__(ELL_THREADS)
    spmm_ell_kernel(const float* __restrict__ values,
                    const int* __restrict__ cols, const float* __restrict__ x,
                    float* __restrict__ y, int nrows, int width, int k) {
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  const int col = blockIdx.y * blockDim.x + threadIdx.x;
  if (row >= nrows || col >= k) return;
  const float* v = values + (size_t)row * width;
  const int* c = cols + (size_t)row * width;
  float acc = 0.f;
  for (int w = 0; w < width; ++w)
    acc = fmaf(__ldg(v + w), __ldg(x + (size_t)__ldg(c + w) * k + col), acc);
  y[(size_t)row * k + col] = acc;
}

template <int BS>
__global__ void __launch_bounds__(BSR_THREADS)
    spmm_bsr_kernel(const float* __restrict__ values,
                    const int* __restrict__ cols, const int* __restrict__ rowp,
                    const float* __restrict__ x, float* __restrict__ y,
                    int k) {
  constexpr int ROWS_PER_PASS = BSR_THREADS / BSR_PANEL;  // 8
  constexpr int RPT = BS / ROWS_PER_PASS;                 // outputs/thread
  __shared__ float blk[BS][BS];
  __shared__ float xs[BS][BSR_PANEL];
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
    const float* vp = values + (size_t)p * BS * BS;
    for (int e = threadIdx.x; e < BS * BS; e += BSR_THREADS)
      blk[e / BS][e % BS] = __ldg(vp + e);
    const float* xp = x + (size_t)__ldg(cols + p) * BS * k;
    for (int e = threadIdx.x; e < BS * BSR_PANEL; e += BSR_THREADS) {
      const int r = e / BSR_PANEL;
      const int c = c0 + e % BSR_PANEL;
      xs[r][e % BSR_PANEL] = c < k ? __ldg(xp + (size_t)r * k + c) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int i = ty + r * ROWS_PER_PASS;
#pragma unroll
      for (int t = 0; t < BS; ++t) acc[r] = fmaf(blk[i][t], xs[t][tx], acc[r]);
    }
    __syncthreads();
  }
  const int col = c0 + tx;
  if (col >= k) return;
#pragma unroll
  for (int r = 0; r < RPT; ++r)
    y[((size_t)brow * BS + ty + r * ROWS_PER_PASS) * k + col] = acc[r];
}

template <int BS>
int launch_bsr(const void* values, const void* cols, const void* rowp,
               const void* x, void* y, int nbrows, int k,
               cudaStream_t stream) {
  const dim3 grid(nbrows, (k + BSR_PANEL - 1) / BSR_PANEL);
  spmm_bsr_kernel<BS><<<grid, BSR_THREADS, 0, stream>>>(
      static_cast<const float*>(values), static_cast<const int*>(cols),
      static_cast<const int*>(rowp), static_cast<const float*>(x),
      static_cast<float*>(y), k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int spmm_ell_launch(const void* values, const void* cols,
                               const void* x, void* y, int nrows, int width,
                               int k, void* stream) {
  // kp threads along k (a power of two <= 32 that covers small k), the rest
  // of the 256 along rows
  int kp = 1;
  while (kp < k && kp < 32) kp <<= 1;
  const dim3 block(kp, ELL_THREADS / kp);
  const dim3 grid((nrows + block.y - 1) / block.y, (k + kp - 1) / kp);
  spmm_ell_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), static_cast<const int*>(cols),
      static_cast<const float*>(x), static_cast<float*>(y), nrows, width, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spmm_bsr_launch(const void* values, const void* cols,
                               const void* rowp, const void* x, void* y,
                               int nbrows, int bs, int k, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bs) {
    case 8:
      return launch_bsr<8>(values, cols, rowp, x, y, nbrows, k, s);
    case 16:
      return launch_bsr<16>(values, cols, rowp, x, y, nbrows, k, s);
    case 32:
      return launch_bsr<32>(values, cols, rowp, x, y, nbrows, k, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
