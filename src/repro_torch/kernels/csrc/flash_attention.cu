// Dense-grid flash attention with GQA, in CUDA for sm_90a: f32 or bf16 q, k,
// v; f32 softmax state.  Two kernels from one body:
//
//   flash_attention_kernel       replaces the Pallas TPU kernels
//                                src/repro/kernels/flash_attention.py:154
//                                (flash_attention_kernel) and :167
//                                (flash_attention_state_kernel)
//   flash_attention_lens_kernel  replaces :183 (flash_attention_lens_kernel)
//                                and :201 (..._lens_state_kernel): the same
//                                recurrence plus the per-batch key-prefix
//                                mask kpos < kv_len[b] (paged decode and the
//                                prefix half of chunked prefill)
//
// Template flags: CAUSAL (iota compare qpos >= kpos, no tail offset, as the
// Pallas kernel), STATE (also write the final m, l).
//
// The Pallas grid is (b, h, Lq/bq, Lk/bk) with the K axis sequential and
// (m, l, acc) in VMEM scratch.  Here one CTA owns fa::ROWS consecutive Q
// rows of one (b, h) and loops over the K tiles of block_k keys itself;
// q-head h reads kv-head h / (Hq / Hkv).  Only block_k fixes the order of
// summation (each row's online softmax folds one K tile at a time), so the
// CTA's Q rows need not match the Pallas block_q.  A K tile is skipped when
// it is wholly past kv_len[b] or wholly above the diagonal for every row of
// the CTA: for a row with a live key such a tile changes nothing (alpha = 1
// and p = 0 exactly), and a row with no live key keeps m = NEG_INF, which is
// all a state merge reads of it.  When block_k does not divide Lk the last
// K tile is short: fold_tile takes any tile of at most BK_MAX keys, and a
// short tile folds exactly as a full one whose extra keys are masked.
//
// Bound on this card: 4 * B * Hq * Lq * Lk_live * d flops against the bytes
// of q, k, v and o.  At the prefill shape (B = 4, Hq = 16, L = 512, d = 128,
// bf16) the flops dominate, a few microseconds at the tensor-core rate; this
// kernel runs the products on the f32 FMA units with both operands staged
// in shared memory, so it is bound by shared-memory traffic, far from that.
// At paged decode (Lq = 1) it is bytes-bound: each CTA streams its slot's
// live keys once.
#include "flash_attention.cuh"

namespace {

using fa::ROWS;

template <typename T>
struct GridArgs {
  const T* q;
  const T* k;
  const T* v;
  const int* lens;  // (B,) or null
  T* o;
  float* m;  // (B, Hq, Lq) or null
  float* l;
  int hq, hkv, lq, lk, block_k;
  float scale;
};

template <bool CAUSAL, bool LENS>
struct GridMask {
  int qpos0;  // absolute q position of the warp's row 0
  int k0;     // absolute key position of the tile's key 0
  int kv_len;
  __device__ __forceinline__ float operator()(int r, int j, float s) const {
    const int kpos = k0 + j;
    bool live = true;
    if (CAUSAL) live = qpos0 + r >= kpos;
    if (LENS) live = live && kpos < kv_len;
    return live ? s : fa::NEG_INF;
  }
};

template <typename T, int D, bool CAUSAL, bool STATE, bool LENS>
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
  int kv_len = a.lk;
  if (LENS) {
    kv_len = min(max(a.lens[b], 0), a.lk);
    kend = kv_len;
  }
  if (CAUSAL) kend = min(kend, min(q0 + ROWS, a.lq));
  const int warp_row0 = q0 + (threadIdx.x / 32) * fa::RPW;
  const bool warp_live = warp_row0 < a.lq;

  fa::State<D> st;
  st.init();
  for (int k0 = 0; k0 < kend; k0 += a.block_k) {
    const GridMask<CAUSAL, LENS> mask{warp_row0, k0, kv_len};
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
  grid_body<T, D, CAUSAL, STATE, false>(a);
}

template <typename T, int D, bool CAUSAL, bool STATE>
__global__ void __launch_bounds__(fa::THREADS)
    flash_attention_lens_kernel(GridArgs<T> a) {
  grid_body<T, D, CAUSAL, STATE, true>(a);
}

template <typename T, int D, bool CAUSAL, bool STATE>
int launch(const GridArgs<T>& a, int batch, cudaStream_t stream) {
  const dim3 grid((a.lq + ROWS - 1) / ROWS, a.hq, batch);
  const size_t bytes = fa::smem_bytes<T, D>();
  cudaError_t err;
  if (a.lens != nullptr) {
    auto kernel = flash_attention_lens_kernel<T, D, CAUSAL, STATE>;
    err = fa::allow_smem(kernel, bytes);
    if (err == cudaSuccess)
      kernel<<<grid, fa::THREADS, bytes, stream>>>(a);
  } else {
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
int launch_dtype(const void* q, const void* k, const void* v,
                 const void* lens, void* o, void* m, void* l, int batch,
                 int hq, int hkv, int lq, int lk, int d, int block_k,
                 float scale, bool causal, bool state, cudaStream_t s) {
  const GridArgs<T> a{static_cast<const T*>(q), static_cast<const T*>(k),
                      static_cast<const T*>(v), static_cast<const int*>(lens),
                      static_cast<T*>(o), static_cast<float*>(m),
                      static_cast<float*>(l), hq, hkv, lq, lk, block_k,
                      scale};
  switch (d) {
    case 32:
      return launch_flags<T, 32>(a, batch, causal, state, s);
    case 64:
      return launch_flags<T, 64>(a, batch, causal, state, s);
    case 128:
      return launch_flags<T, 128>(a, batch, causal, state, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, Hq, Lq, d), k / v (B, Hkv, Lk, d), o like q; m, l (B, Hq, Lq) f32
// when state; lens (B,) int32 or null.  dtype 0 = f32, 1 = bf16.  The
// caller checks shapes: Hq % Hkv == 0, block_k <= 128, d in {32, 64, 128};
// any Lq and Lk (the last K tile may be short).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, const void* lens,
                                      void* o, void* m, void* l, int batch,
                                      int hq, int hkv, int lq, int lk, int d,
                                      int block_k, float scale, int causal,
                                      int state, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block_k < 1 || block_k > fa::BK_MAX || hkv < 1 || hq % hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_dtype<float>(q, k, v, lens, o, m, l, batch, hq, hkv, lq,
                               lk, d, block_k, scale, causal, state, s);
  if (dtype == 1)
    return launch_dtype<__nv_bfloat16>(q, k, v, lens, o, m, l, batch, hq,
                                       hkv, lq, lk, d, block_k, scale,
                                       causal, state, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
