// Shared pieces of the two f32 flash-attention kernels (flash_attention.cu,
// the dense grid; flash_attention_tiles.cu, the tile-skipping walk over a
// compiled TileLayout): the CTA shape, the shared-memory plan, and
// fold_tile, which folds one K/V tile into the online-softmax state
// (m, l, acc) of a CTA's Q rows, at head_dim 32, 64, 96, 112, 128 or 256
// (a lane owns ceil(D / 32) columns: at 112 lanes 0-15 own a fourth one and
// lanes 16-31 hold a dead slot that is never read or written; 153 KB of
// shared memory at 256).  The
// conversions to_f, round_to and from_f serve the bf16 kernels too.  Both
// kernels fold every tile through fold_tile, so a row's arithmetic depends
// only on its q, the tiles it visits and their order, and not on which
// kernel or which CTA shape runs it.  That is what makes the tiles kernel
// over a causal layout bitwise equal to the dense grid with causal=True in
// f32.
//
// The recurrence is _fa_step of src/repro/kernels/flash_attention.py:101:
//   s = (q . k) * scale, masked to NEG_INF
//   m_cur = max(m_prev, max_j s_j); alpha = exp(m_prev - m_cur)
//   p_j = exp(s_j - m_cur); l = l * alpha + sum_j p_j
//   acc = acc * alpha + sum_j round_to_V(p_j) * v_j
// in f32, with expf (no fast math) and every operation written as an
// explicit round-to-nearest intrinsic, so that the compiler cannot contract
// or reorder it differently in the two kernels.
//
// CTA: WARPS warps, RPW Q rows per warp (ROWS rows in all).  In the score
// phase lane l owns keys l, l + 32, l + 64, l + 96 of the tile and runs the
// d loop serially for each (row, key); row max and row sum are a serial
// pass over the lane's keys and then a fixed xor butterfly.  In the P.V
// phase lane l owns columns l, l + 32, ... of the rows and sums over the
// tile's keys serially.  K is staged transposed (kT[d][j], stride
// BK_MAX + 1) so that lanes reading neighbouring keys hit neighbouring
// banks; V is staged row-major in the same buffer after the scores are
// done.  Q rows are converted to f32 once per CTA.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fa {

constexpr float NEG_INF = -1e30f;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int RPW = 4;               // Q rows per warp
constexpr int ROWS = WARPS * RPW;    // Q rows per CTA
constexpr int BK_MAX = 128;          // the largest K tile the kernels take
constexpr int KPL = BK_MAX / 32;     // keys per lane in the score phase
constexpr int KT_STRIDE = BK_MAX + 1;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// p.astype(v.dtype), read back as f32 (round to nearest even for bf16)
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Dynamic shared memory of one CTA: q_s (ROWS x D f32), p_s (ROWS x BK_MAX
// f32), then the K/V buffer (D x KT_STRIDE elements of T, which also holds
// a BK_MAX x D V tile).
template <typename T, int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (ROWS * D + ROWS * BK_MAX) +
         sizeof(T) * D * KT_STRIDE;
}

// The online-softmax state of one warp's RPW rows; every lane holds m and l
// of each row and its ceil(D / 32) columns of acc (column lane + 32 u).
template <int D>
struct State {
  static constexpr int CPL = (D + 31) / 32;
  // whether the lane's u-th column is a column of the head (always, unless
  // 32 does not divide D)
  static __device__ __forceinline__ bool owns(int lane, int u) {
    return D % 32 == 0 || lane + 32 * u < D;
  }
  float m[RPW];
  float l[RPW];
  float acc[RPW][CPL];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      m[r] = NEG_INF;
      l[r] = 0.f;
#pragma unroll
      for (int u = 0; u < CPL; ++u) acc[r][u] = 0.f;
    }
  }
};

struct NoMask {
  __device__ __forceinline__ float operator()(int, int, float s) const {
    return s;
  }
};

// Copy q rows [q0, q0 + ROWS) of one (b, h) into q_s as f32; rows at or past
// nrows are zero.
template <typename T, int D>
__device__ __forceinline__ void stage_q(const T* __restrict__ q, int q0,
                                        int nrows, float* q_s) {
  for (int e = threadIdx.x; e < ROWS * D; e += THREADS) {
    const int row = e / D;
    q_s[e] = q0 + row < nrows ? to_f(q[(size_t)(q0 + row) * D + e % D]) : 0.f;
  }
}

// Fold the bk keys at kg / vg (bk x D each, contiguous) into st.  Called by
// every thread of the CTA (it holds __syncthreads); warps whose rows are all
// dead (warp_live false) stage but skip the arithmetic.  mask(r, j, s)
// returns the masked score of the warp's row r and tile key j.
template <typename T, int D, class Mask>
__device__ __forceinline__ void fold_tile(const T* __restrict__ kg,
                                          const T* __restrict__ vg, int bk,
                                          float scale, bool warp_live,
                                          const float* q_s, float* p_s,
                                          T* kv_s, State<D>& st,
                                          const Mask& mask) {
  constexpr int CPL = State<D>::CPL;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * RPW;

  // K tile, transposed: kv_s[d * KT_STRIDE + j]
  for (int e = threadIdx.x; e < bk * D; e += THREADS)
    kv_s[(e % D) * KT_STRIDE + e / D] = kg[e];
  __syncthreads();

  float alpha[RPW];
  if (warp_live) {
    float s[RPW][KPL];
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
      for (int t = 0; t < KPL; ++t) s[r][t] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; ++dd) {
      float qv[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r) qv[r] = q_s[(r0 + r) * D + dd];
      const T* kr = kv_s + dd * KT_STRIDE;
#pragma unroll
      for (int t = 0; t < KPL; ++t) {
        const int j = lane + 32 * t;
        const float kv = j < bk ? to_f(kr[j]) : 0.f;
#pragma unroll
        for (int r = 0; r < RPW; ++r) s[r][t] = fmaf(qv[r], kv, s[r][t]);
      }
    }
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      float mx = __int_as_float(0xff800000);  // -inf
#pragma unroll
      for (int t = 0; t < KPL; ++t) {
        const int j = lane + 32 * t;
        if (j < bk) {
          s[r][t] = mask(r, j, __fmul_rn(s[r][t], scale));
          mx = fmaxf(mx, s[r][t]);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_cur = fmaxf(st.m[r], mx);
      alpha[r] = expf(__fsub_rn(st.m[r], m_cur));
      float ps = 0.f;
#pragma unroll
      for (int t = 0; t < KPL; ++t) {
        const int j = lane + 32 * t;
        if (j < bk) {
          const float p = expf(__fsub_rn(s[r][t], m_cur));
          ps = __fadd_rn(ps, p);
          p_s[(r0 + r) * BK_MAX + j] = round_to<T>(p);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps = __fadd_rn(ps, __shfl_xor_sync(0xffffffffu, ps, off));
      st.l[r] = __fadd_rn(__fmul_rn(st.l[r], alpha[r]), ps);
      st.m[r] = m_cur;
    }
  }
  __syncthreads();

  // V tile, row-major: kv_s[j * D + c]
  for (int e = threadIdx.x; e < bk * D; e += THREADS) kv_s[e] = vg[e];
  __syncthreads();

  if (warp_live) {
    float pv[RPW][CPL];
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
      for (int u = 0; u < CPL; ++u) pv[r][u] = 0.f;
#pragma unroll 2
    for (int j = 0; j < bk; ++j) {
      float pj[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r) pj[r] = p_s[(r0 + r) * BK_MAX + j];
#pragma unroll
      for (int u = 0; u < CPL; ++u) {
        const float vv =
            State<D>::owns(lane, u) ? to_f(kv_s[j * D + lane + 32 * u]) : 0.f;
#pragma unroll
        for (int r = 0; r < RPW; ++r) pv[r][u] = fmaf(pj[r], vv, pv[r][u]);
      }
    }
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
      for (int u = 0; u < CPL; ++u)
        st.acc[r][u] =
            __fadd_rn(__fmul_rn(st.acc[r][u], alpha[r]), pv[r][u]);
  }
  __syncthreads();
}

// o = acc / max(l, 1e-30) in q's type, 0 on a row with no live key (m ==
// NEG_INF, where acc / l would be the mean of the walked V rows: the walks
// that flush through here are differentiable, and their backward gives
// such rows no probability), and the state (m, l) when m_out is given, for
// the warp's rows below nrows.  o points at row q0 of (b, h).
template <typename T, int D>
__device__ __forceinline__ void flush(const State<D>& st, int q0, int nrows,
                                      T* __restrict__ o, float* m_out,
                                      float* l_out) {
  constexpr int CPL = State<D>::CPL;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = q0 + warp * RPW + r;
    if (row >= nrows) continue;
    const float denom = fmaxf(st.l[r], 1e-30f);
    const bool dead = st.m[r] <= NEG_INF;
#pragma unroll
    for (int u = 0; u < CPL; ++u)
      if (State<D>::owns(lane, u))
        o[(size_t)row * D + lane + 32 * u] =
            from_f<T>(dead ? 0.f : __fdiv_rn(st.acc[r][u], denom));
    if (m_out != nullptr && lane == 0) {
      m_out[row] = st.m[r];
      l_out[row] = st.l[r];
    }
  }
}

// Raise a kernel's dynamic shared-memory limit (above 48 KB it must be
// asked for) before its launch.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace fa
