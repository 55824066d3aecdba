// Dense-grid flash attention with GQA, in CUDA for sm_90a: f32 or bf16 q, k,
// v; f32 softmax state.  Two kernels replace the Pallas TPU kernels
// src/repro/kernels/flash_attention.py:154 (flash_attention_kernel) and
// :167 (flash_attention_state_kernel):
//
//   flash_attention_kernel       f32, the FMA fold
//   flash_attention_bf16_kernel  bf16, the tensor-core fold
//
// The key-length kernels of :183 and :201 (paged decode and the prefix
// half of chunked prefill) are split-K kernels of their own, in
// flash_attention_lens.cu.
//
// Template flags: CAUSAL (iota compare qpos >= kpos, no tail offset, as the
// Pallas kernel), STATE (also write the final m, l).  The Pallas grid is
// (b, h, Lq/bq, Lk/bk) with the K axis sequential and (m, l, acc) in VMEM
// scratch.  Here one CTA owns consecutive Q rows of one (b, h) and loops
// over the K tiles of block_k keys itself; q-head h reads kv-head
// h / (Hq / Hkv).  Only block_k fixes the order of summation (each row's
// online softmax folds one K tile at a time), so the CTA's Q rows need not
// match the Pallas block_q.  When block_k does not divide Lk the last K
// tile is short and folds exactly as a full one whose extra keys are
// masked.  A K tile wholly above the diagonal for every row of the CTA is
// skipped: for a row with a live key such a tile changes nothing (alpha = 1
// and p = 0 exactly).  Both kernels are compiled at head_dim 32, 64, 96,
// 112, 128 and 256.
//
// bf16 runs flash_attention_bf16_kernel: up to 128 Q rows a CTA (a
// warpgroup per 64), K tiles 0 .. ceil(kend / block_k) folded on the
// tensor cores by tc::fold_rows (flash_attention_wgmma.cuh), the fold the
// bf16 tiles kernel runs, with the causal compare applied to every tile; so
// the dense causal grid is bitwise equal to the tiles walk over
// causal_layout in bf16.  Bound and design: flash_attention_wgmma.cuh.  The
// CTAs of the longest causal walks (the last Q rows) start first.
//
// f32 runs grid_body: fa::ROWS Q rows a CTA folded by fa::fold_tile on the
// f32 FMA units (flash_attention.cuh), bitwise equal to the f32 tiles
// kernel over causal_layout.
#include <limits.h>

#include <type_traits>

#include "flash_attention_wgmma.cuh"

namespace {

using fa::ROWS;

template <typename T>
struct GridArgs {
  const T* q;
  const T* k;
  const T* v;
  T* o;
  float* m;  // (B, Hq, Lq) or null
  float* l;
  int hq, hkv, lq, lk, block_k;
  float scale;
};

template <bool CAUSAL>
struct GridMask {
  int qpos0;  // absolute q position of the warp's row 0
  int k0;     // absolute key position of the tile's key 0
  __device__ __forceinline__ float operator()(int r, int j, float s) const {
    if (CAUSAL && qpos0 + r < k0 + j) return fa::NEG_INF;
    return s;
  }
};

template <typename T, int D, bool CAUSAL, bool STATE>
__device__ __forceinline__ void grid_body(const GridArgs<T>& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* p_s = q_s + ROWS * D;
  T* kv_s = reinterpret_cast<T*>(p_s + ROWS * fa::BK_MAX);

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int hk = h / (a.hq / a.hkv);
  const int q0 = blockIdx.x * ROWS;
  const size_t bh = (size_t)b * a.hq + h;
  const size_t bhk = (size_t)b * a.hkv + hk;
  const T* kb = a.k + bhk * a.lk * D;
  const T* vb = a.v + bhk * a.lk * D;

  fa::stage_q<T, D>(a.q + bh * a.lq * D, q0, a.lq, q_s);
  __syncthreads();

  int kend = a.lk;
  if (CAUSAL) kend = min(kend, min(q0 + ROWS, a.lq));
  const int warp_row0 = q0 + (threadIdx.x / 32) * fa::RPW;
  const bool warp_live = warp_row0 < a.lq;

  fa::State<D> st;
  st.init();
  for (int k0 = 0; k0 < kend; k0 += a.block_k) {
    const GridMask<CAUSAL> mask{warp_row0, k0};
    fa::fold_tile<T, D>(kb + (size_t)k0 * D, vb + (size_t)k0 * D,
                        min(a.block_k, a.lk - k0), a.scale, warp_live, q_s,
                        p_s, kv_s, st, mask);
  }
  fa::flush<T, D>(st, q0, a.lq, a.o + bh * a.lq * D,
                  STATE ? a.m + bh * a.lq : nullptr,
                  STATE ? a.l + bh * a.lq : nullptr);
}

template <typename T, int D, bool CAUSAL, bool STATE>
__global__ void __launch_bounds__(fa::THREADS)
    flash_attention_kernel(GridArgs<T> a) {
  grid_body<T, D, CAUSAL, STATE>(a);
}

// The dense walk: K tiles 0 .. n - 1 in order, each under the causal
// compare when CAUSAL.
template <bool CAUSAL>
struct DenseWalk {
  int n, block_k;
  __device__ __forceinline__ int ntile() const { return n; }
  __device__ __forceinline__ int col(int t) const { return t; }
  __device__ __forceinline__ bool masked(int) const { return CAUSAL; }
  __device__ __forceinline__ float mask(int, int c, int row, int key,
                                        float x) const {
    return row >= c * block_k + key ? x : fa::NEG_INF;
  }
};

// One CTA per (Q block of blockDim.x / 2 rows, b, h); blockIdx.x runs h
// fastest, then b, then the Q block (the last first when CAUSAL).
template <int D, bool CAUSAL, bool STATE>
__global__ void __launch_bounds__(tc::THREADS_MAX, 1)
    flash_attention_bf16_kernel(GridArgs<__nv_bfloat16> a, int batch) {
  const int rows_cta = blockDim.x / 2;  // 64 rows per 128 threads
  const int nq = (a.lq + rows_cta - 1) / rows_cta;
  int id = blockIdx.x;
  const int h = id % a.hq;
  id /= a.hq;
  const int b = id % batch;
  id /= batch;
  const int q0 = (CAUSAL ? nq - 1 - id : id) * rows_cta;
  const int qend = min(q0 + rows_cta, a.lq);
  const int kend = CAUSAL ? min(a.lk, qend) : a.lk;
  const int hk = h / (a.hq / a.hkv);
  const size_t bh = (size_t)b * a.hq + h;
  const size_t bhk = (size_t)b * a.hkv + hk;
  const DenseWalk<CAUSAL> walk{(kend + a.block_k - 1) / a.block_k,
                               a.block_k};
  tc::FoldOut dst{a.o + bh * a.lq * D, STATE ? a.m + bh * a.lq : nullptr,
                  STATE ? a.l + bh * a.lq : nullptr};
  dst.zero_dead = true;
  tc::fold_rows<D, STATE>(a.q + bh * a.lq * D, a.k + bhk * a.lk * D,
                          a.v + bhk * a.lk * D, dst, q0, qend, a.lk,
                          a.block_k, a.scale, walk);
}

template <typename T, int D, bool CAUSAL, bool STATE>
int launch(const GridArgs<T>& a, int batch, cudaStream_t stream) {
  cudaError_t err;
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const int wgs = a.lq > 64 ? tc::WG_MAX : 1;
    const long long blocks =
        (long long)((a.lq + wgs * 64 - 1) / (wgs * 64)) * a.hq * batch;
    if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    const size_t bytes = tc::smem_bytes<D>(wgs * 64, a.block_k);
    auto kernel = flash_attention_bf16_kernel<D, CAUSAL, STATE>;
    err = fa::allow_smem(kernel, bytes);
    if (err == cudaSuccess)
      kernel<<<static_cast<unsigned>(blocks), wgs * 128, bytes, stream>>>(
          a, batch);
  } else {
    const dim3 grid((a.lq + ROWS - 1) / ROWS, a.hq, batch);
    const size_t bytes = fa::smem_bytes<T, D>();
    auto kernel = flash_attention_kernel<T, D, CAUSAL, STATE>;
    err = fa::allow_smem(kernel, bytes);
    if (err == cudaSuccess)
      kernel<<<grid, fa::THREADS, bytes, stream>>>(a);
  }
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename T, int D>
int launch_flags(const GridArgs<T>& a, int batch, bool causal, bool state,
                 cudaStream_t s) {
  if (causal)
    return state ? launch<T, D, true, true>(a, batch, s)
                 : launch<T, D, true, false>(a, batch, s);
  return state ? launch<T, D, false, true>(a, batch, s)
               : launch<T, D, false, false>(a, batch, s);
}

template <typename T>
int launch_dtype(const void* q, const void* k, const void* v, void* o,
                 void* m, void* l, int batch, int hq, int hkv, int lq,
                 int lk, int d, int block_k, float scale, bool causal,
                 bool state, cudaStream_t s) {
  const GridArgs<T> a{static_cast<const T*>(q), static_cast<const T*>(k),
                      static_cast<const T*>(v), static_cast<T*>(o),
                      static_cast<float*>(m), static_cast<float*>(l),
                      hq, hkv, lq, lk, block_k, scale};
  switch (d) {
    case 32:
      return launch_flags<T, 32>(a, batch, causal, state, s);
    case 64:
      return launch_flags<T, 64>(a, batch, causal, state, s);
    case 96:
      return launch_flags<T, 96>(a, batch, causal, state, s);
    case 112:
      return launch_flags<T, 112>(a, batch, causal, state, s);
    case 128:
      return launch_flags<T, 128>(a, batch, causal, state, s);
    case 256:
      return launch_flags<T, 256>(a, batch, causal, state, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, Hq, Lq, d), k / v (B, Hkv, Lk, d), o like q; m, l (B, Hq, Lq) f32
// when state.  dtype 0 = f32, 1 = bf16 (the tensor-core kernel, q, k, v
// 16-byte aligned).  The caller checks shapes: Hq % Hkv == 0,
// block_k <= 128, d in {32, 64, 96, 112, 128, 256}; any Lq and Lk (the last K
// tile may be short).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* m,
                                      void* l, int batch, int hq, int hkv,
                                      int lq, int lk, int d, int block_k,
                                      float scale, int causal, int state,
                                      int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block_k < 1 || block_k > fa::BK_MAX || hkv < 1 || hq % hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_dtype<float>(q, k, v, o, m, l, batch, hq, hkv, lq, lk, d,
                               block_k, scale, causal, state, s);
  if (dtype == 1)
    return launch_dtype<__nv_bfloat16>(q, k, v, o, m, l, batch, hq, hkv, lq,
                                       lk, d, block_k, scale, causal, state,
                                       s);
  return static_cast<int>(cudaErrorInvalidValue);
}
