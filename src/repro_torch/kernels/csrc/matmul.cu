// Dense matmul C = A @ B for mod2am, in CUDA for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/matmul.py:35
// (matmul_kernel): a (M/bm, N/bn, K/bk) grid whose K axis runs in order and
// carries an f32 accumulator in VMEM.  On Hopper the blocks of a grid run in
// no order, so the K loop moves inside the block: each block owns one 64x64
// output tile, walks K in steps of 16 through shared memory, and keeps its
// sums in registers (4x4 per thread, 256 threads).
//
// Bound on this card: operations.  At n = 1024 the product needs 2 n^3 =
// 2.1 GFLOP against 12 MB of traffic, so the 67 TFLOP/s of f32 FMA outside
// the tensor cores bounds it (about 32 us).  f32 must stay IEEE (the parity
// bar is 2e-5), so TF32 tensor cores are not an option for f32; wgmma with
// TMA for bf16 is later work.  Ragged M/N/K edges are masked on load and on
// store, so no caller pads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16, THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename O> __device__ __forceinline__ O from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, typename O>
__global__ void __launch_bounds__(THREADS)
    matmul_kernel(const T* __restrict__ A, const T* __restrict__ B,
                  O* __restrict__ C, int M, int N, int K) {
  __shared__ float As[BK][BM + 4];  // A tile, stored k-major
  __shared__ float Bs[BK][BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int gr = row0 + r, gc = k0 + c;
      As[c][r] = (gr < M && gc < K) ? to_f32(A[(size_t)gr * K + gc]) : 0.f;
    }
#pragma unroll
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const int gr = k0 + r, gc = col0 + c;
      Bs[r][c] = (gr < K && gc < N) ? to_f32(B[(size_t)gr * N + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < N) C[(size_t)r * N + c] = from_f32<O>(acc[i][j]);
    }
  }
}

template <typename T, typename O>
void launch(const void* a, const void* b, void* c, int M, int N, int K,
            cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  matmul_kernel<T, O><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<O*>(c),
      M, N, K);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
extern "C" int matmul_launch(const void* a, const void* b, void* c, int M,
                             int N, int K, int in_dtype, int out_dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0)
    launch<float, float>(a, b, c, M, N, K, s);
  else if (in_dtype == 0 && out_dtype == 1)
    launch<float, __nv_bfloat16>(a, b, c, M, N, K, s);
  else if (in_dtype == 1 && out_dtype == 0)
    launch<__nv_bfloat16, float>(a, b, c, M, N, K, s);
  else if (in_dtype == 1 && out_dtype == 1)
    launch<__nv_bfloat16, __nv_bfloat16>(a, b, c, M, N, K, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
