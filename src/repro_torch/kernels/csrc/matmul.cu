// Dense matmul C = A @ B for mod2am, in CUDA for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/matmul.py:35
// (matmul_kernel): a (M/bm, N/bn, K/bk) grid whose K axis runs in order and
// carries an f32 accumulator in VMEM.  On Hopper the blocks of a grid run in
// no order, so the K loop moves inside the block: each block owns one
// output tile and walks K in slabs through shared memory, with the sums in
// registers.
//
// Bound on this card: operations.  At n = 1024 the product needs 2 n^3 =
// 2.1 GFLOP against 12 MB of traffic, so the 67 TFLOP/s of f32 FMA outside
// the tensor cores bounds it (about 32 us).  f32 must stay IEEE (the parity
// bar is 2e-5), so TF32 tensor cores are not an option for f32; each
// output is one fmaf chain in ascending k, as in a plain loop.
//
// Design.  A CTA of 128 threads owns a 128 x 64 tile of C; thread
// (ty, tx) = (tid / 8, tid % 8) owns the 8 x 8 outputs at rows ty + 16 i
// and columns 4 tx + j, 32 + 4 tx + j.  The tile is picked by the wave
// count at n = 1024 on 132 SMs: 128 x 128 tiles give 64 CTAs, under half
// of the SMs; 128 x 64 give 128 CTAs, 0.97 of a wave, one CTA per SM; 64 x
// 64 give 256 CTAs, 1.94 waves (at 8 x 8 outputs a thread both run the
// same 512 warps, but 128 x 64 loads fewer bytes per FMA and leaves no SM
// with twice the work).  K runs in slabs of 16 through shared memory,
// three stages deep where the copies are 16-byte cp.async (f32, K and N
// multiples of 4, 16-byte aligned): slabs t + 1 and t + 2 load while slab
// t is multiplied, since one slab's 1024 FMAs a thread are shorter than a
// load's latency.  A slab of A stays m-major (row r, 16 floats of k), so
// cp.async copies it as it lies in memory and each 16-byte copy lands on
// its own 4 banks; a thread reads each of its 8 rows four k at a time as a
// float4 (the 8 lanes of a quarter warp share the row: one broadcast).
// B's slab is k-major (16 x 64); a thread reads its 8 columns as two
// float4 at 4 tx and 32 + 4 tx, so a quarter warp's 8 lanes cover all 32
// banks.  Copies past the edges are zero-filled.  Otherwise two stages:
// each thread loads its share of slab t + 1 into registers with bounds
// tests before slab t is multiplied and stores it after.  That path serves
// what 16-byte copies cannot: bf16 in (cp.async cannot convert to f32,
// and a bf16 row of odd length starts on a 2-byte boundary, below the
// 4 bytes a copy moves) and f32 with K or N not a multiple of 4 (mod2am's
// full sweep at n = 10 and 50).  PERF.md times it at n = 1024 in bf16 and
// n = 1023 in f32.
// Ragged M/N/K edges are masked on load and on store, so no caller pads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 128, BN = 64, BK = 16, THREADS = 128;

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

// 16 bytes global -> shared, or 16 zero bytes when !valid
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// acc += the slab in stage (As, Bs): thread (ty, tx) reads its rows
// ty + 16 i four k at a time (float4) and its columns 4 tx, 32 + 4 tx
// (two float4) for each k, in ascending k.
__device__ __forceinline__ void mma_slab(const float* As, const float* Bs,
                                         int ty, int tx, float (&acc)[8][8]) {
#pragma unroll
  for (int kq = 0; kq < BK / 4; ++kq) {
    float a[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 v =
          *reinterpret_cast<const float4*>(As + (ty + 16 * i) * BK + 4 * kq);
      a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* brow = Bs + (4 * kq + kk) * BN;
      const float4 b0 = *reinterpret_cast<const float4*>(brow + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(brow + 32 + 4 * tx);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = fmaf(a[i][kk], b[j], acc[i][j]);
    }
  }
}

// VEC: the operands take 16-byte cp.async (f32, K % 4 == 0, N % 4 == 0,
// A, B and C 16-byte aligned); three stages, slabs t + 1 and t + 2 in
// flight while slab t is multiplied.  Otherwise two stages, the next slab
// loaded into registers (converted to f32, bounds-tested) during this one.
template <typename T, typename O, bool VEC>
__global__ void __launch_bounds__(THREADS)
    matmul_kernel(const T* __restrict__ A, const T* __restrict__ B,
                  O* __restrict__ C, int M, int N, int K) {
  constexpr int NS = VEC ? 3 : 2;
  __shared__ __align__(16) float As[NS][BM * BK];  // row r at r * BK
  __shared__ __align__(16) float Bs[NS][BK * BN];  // row k at k * BN
  const int tid = threadIdx.x;
  const int tx = tid % 8, ty = tid / 8;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int slabs = (K + BK - 1) / BK;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  if constexpr (VEC) {
    // slab t into stage st: A as 16-byte chunks (row e / 4, k 4 (e % 4)),
    // B as 16-byte chunks (row e / 16, column 4 (e % 16)); one group
    auto load = [&](int t, int st) {
      const int k0 = t * BK;
      if (t < slabs) {
#pragma unroll
        for (int u = 0; u < BM * BK / 4 / THREADS; ++u) {
          const int e = tid + THREADS * u;
          const int r = e / (BK / 4), c = 4 * (e % (BK / 4));
          const bool ok = row0 + r < M && k0 + c < K;
          cp_async16(&As[st][r * BK + c],
                     A + (ok ? (size_t)(row0 + r) * K + k0 + c : 0), ok);
        }
#pragma unroll
        for (int u = 0; u < BK * BN / 4 / THREADS; ++u) {
          const int e = tid + THREADS * u;
          const int r = e / (BN / 4), c = 4 * (e % (BN / 4));
          const bool ok = k0 + r < K && col0 + c < N;
          cp_async16(&Bs[st][r * BN + c],
                     B + (ok ? (size_t)(k0 + r) * N + col0 + c : 0), ok);
        }
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    load(0, 0);
    load(1, 1);
    for (int t = 0; t < slabs; ++t) {
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // slab t
      __syncthreads();  // and every thread is done with slab t - 1
      load(t + 2, (t + 2) % NS);
      mma_slab(As[t % NS], Bs[t % NS], ty, tx, acc);
    }
  } else {
    // the slab's elements tid + 128 u: A row e / 16, k e % 16; B row
    // e / 64, column e % 64
    float ra[BM * BK / THREADS], rb[BK * BN / THREADS];
    auto load = [&](int t) {
      const int k0 = t * BK;
#pragma unroll
      for (int u = 0; u < BM * BK / THREADS; ++u) {
        const int e = tid + THREADS * u;
        const int r = row0 + e / BK, c = k0 + e % BK;
        ra[u] = r < M && c < K ? to_f32(A[(size_t)r * K + c]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < BK * BN / THREADS; ++u) {
        const int e = tid + THREADS * u;
        const int r = k0 + e / BN, c = col0 + e % BN;
        rb[u] = r < K && c < N ? to_f32(B[(size_t)r * N + c]) : 0.f;
      }
    };
    auto store = [&](int st) {
#pragma unroll
      for (int u = 0; u < BM * BK / THREADS; ++u)
        As[st][tid + THREADS * u] = ra[u];
#pragma unroll
      for (int u = 0; u < BK * BN / THREADS; ++u)
        Bs[st][tid + THREADS * u] = rb[u];
    };
    if (slabs > 0) {
      load(0);
      store(0);
    }
    __syncthreads();
    for (int t = 0; t < slabs; ++t) {
      if (t + 1 < slabs) load(t + 1);
      mma_slab(As[t & 1], Bs[t & 1], ty, tx, acc);
      if (t + 1 < slabs) store((t + 1) & 1);
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = col0 + 32 * h + 4 * tx;
      O* out = C + (size_t)r * N + c;
      if constexpr (VEC && std::is_same_v<O, float>) {
        if (c < N)
          *reinterpret_cast<float4*>(out) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                          acc[i][4 * h + 2], acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < N) out[j] = from_f32<O>(acc[i][4 * h + j]);
      }
    }
  }
}

template <typename T, typename O>
void launch(const void* a, const void* b, void* c, int M, int N, int K,
            cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  auto kernel = matmul_kernel<T, O, false>;
  if constexpr (std::is_same_v<T, float>) {
    if (K % 4 == 0 && N % 4 == 0 &&
        reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(c) % 16 == 0)
      kernel = matmul_kernel<T, O, true>;
  }
  kernel<<<grid, THREADS, 0, stream>>>(static_cast<const T*>(a),
                                       static_cast<const T*>(b),
                                       static_cast<O*>(c), M, N, K);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
extern "C" int matmul_launch(const void* a, const void* b, void* c, int M,
                             int N, int K, int in_dtype, int out_dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M > 65535 * BM)
    return static_cast<int>(cudaErrorInvalidValue);
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
