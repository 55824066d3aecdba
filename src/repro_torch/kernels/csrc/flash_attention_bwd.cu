// The backward of tile-skipping flash attention (FlashAttention-2's
// backward), in CUDA for sm_90a: f32 or bf16 q, k, v, o, dO; f32 lse, D and
// accumulators; dQ, dK, dV in the input type.  The JAX package has no
// backward kernel (it differentiates through its XLA plane); these kernels
// are the port's own, and walk the same TileLayout as the forward
// (flash_attention_tiles.cu), with the same masks:
//
//   fa_bwd_delta_kernel  D[row] = sum_d dO[row, d] * O[row, d], one warp a
//                        row.
//   fa_bwd_dkdv_kernel   one CTA per (K tile, KS-key part of it, kv head,
//                        b).  It walks the K tile's column of the layout
//                        (the Q tiles that see it, ascending, from the
//                        transposed layout colp / colq / colt), for each q
//                        head of the GQA group in order, in sub-tiles of QS
//                        rows, and accumulates
//                          dV += P^T dO,  dK += dS^T q * scale
//                        with P = exp(S - lse), dP = dO V^T and
//                        dS = P * (dP - D).  dK and dV are written once: no
//                        atomics, and the GQA sum over heads is a fixed
//                        sum, the same bits from run to run.
//   fa_bwd_dq_kernel     one CTA per (Q tile, QS-row part of it, q head,
//                        b).  It walks the Q tile's row of the layout (the
//                        forward's rowp / cols), in sub-tiles of KS keys,
//                        and accumulates dQ += dS K * scale.  No atomics.
//
// S = (q . k) * scale, masked as the forward masks it: FULL tiles not at
// all; PARTIAL tiles by the band compare (template BAND: causal, window,
// offset) or by adding their stored bias tile
// biases[prowp[i] + (p - mid[i])].  lse = m + log(l) of the forward's state
// (f32), and -inf for a row with no live key (m == NEG_INF): such a row has
// P = 0, so it adds nothing to dK and dV and its dQ is 0.  A sub-tile that
// the band masks whole is skipped (its P is 0).
//
// Shared memory holds whole sub-tiles, never whole forward tiles: K and V
// sub-tiles transposed (kt[d][key], stride KS + 1, so that lanes reading
// neighbouring keys and threads writing neighbouring d hit different
// banks), q and dO sub-tiles row-major, all f32; about 140 KB at d = 256.
// The products run on the f32 FMA units: in the score phase lane l owns key
// l of the sub-tile and a warp RPW rows; in the accumulate phase lane l
// owns columns l, l + 32, ... and a warp KS / WARPS keys (dkdv) or RPW rows
// (dq).  Tensor cores (wgmma), TMA and warp specialisation are later work.
#include <limits.h>
#include <math.h>

#include "flash_attention.cuh"

namespace {

using fa::from_f;
using fa::to_f;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int KS = 32;              // keys of a sub-tile (one per lane)
constexpr int QS = 32;              // rows of a sub-tile
constexpr int RPW = QS / WARPS;     // rows per warp in the score phase
constexpr int KPW = KS / WARPS;     // keys per warp in dkdv's accumulate
constexpr int TSTRIDE = KS + 1;

template <typename T>
struct BwdArgs {
  const int* rowp;
  const int* mid;
  const int* prowp;
  const int* cols;
  const float* biases;  // (npart, block_q, block_k)
  const int* colp;      // (nk + 1): column c's entries colp[c] .. colp[c+1]
  const int* colq;      // (ntiles): the Q tile of each column entry
  const int* colt;      // (ntiles): its index p in the row walk
  const T* q;
  const T* k;
  const T* v;
  const T* dout;
  const float* lse;    // (B, Hq, Lq)
  const float* delta;  // (B, Hq, Lq)
  T* dq;
  T* dk;
  T* dv;
  int hq, hkv, lq, lk, block_q, block_k;
  int causal, window, offset;  // the band; window < 0 means none
  float scale;
};

// True when the band masks every (row, key) of rows [qlo, qhi] and keys
// [klo, khi]; q positions here are already shifted by the offset.
__device__ __forceinline__ bool band_dead(int causal, int window, int qlo,
                                          int qhi, int klo, int khi) {
  if (causal && qhi < klo) return true;
  if (window >= 0) {
    if (qlo - khi >= window) return true;
    if (!causal && klo - qhi >= window) return true;
  }
  return false;
}

// The masked score of global row ``row`` (in Q tile i) and global key
// ``key`` (in K tile c), as the forward computes it.
template <typename T, bool BAND>
__device__ __forceinline__ float masked(const BwdArgs<T>& a, bool full,
                                        const float* bias, int i, int c,
                                        int row, int key, float x) {
  if (full) return x;
  if (BAND) {
    const int qb = row + a.offset;
    bool live = true;
    if (a.causal) live = qb >= key;
    if (a.window >= 0)
      live = live && (a.causal ? qb - key < a.window
                               : abs(qb - key) < a.window);
    return live ? x : fa::NEG_INF;
  }
  const int tr = row - i * a.block_q;
  const int tk = key - c * a.block_k;
  return __fadd_rn(x, bias[tr * a.block_k + tk]);
}

// Rows [r0, rend) of one (b, h) into qs / dos as f32 (zero past rend), and
// their lse and D.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(const T* __restrict__ q,
                                           const T* __restrict__ dout,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ delta,
                                           int r0, int rend, float* qs,
                                           float* dos, float* lse_s,
                                           float* del_s) {
  for (int e = threadIdx.x; e < QS * D; e += THREADS) {
    const int row = r0 + e / D;
    const size_t at = (size_t)row * D + e % D;
    const bool ok = row < rend;
    qs[e] = ok ? to_f(q[at]) : 0.f;
    dos[e] = ok ? to_f(dout[at]) : 0.f;
  }
  if (threadIdx.x < QS) {
    const int row = r0 + threadIdx.x;
    lse_s[threadIdx.x] = row < rend ? lse[row] : -INFINITY;
    del_s[threadIdx.x] = row < rend ? delta[row] : 0.f;
  }
}

// Keys [k0, kend) of one (b, kv head) into kt / vt, transposed, as f32
// (zero past kend).
template <typename T, int D>
__device__ __forceinline__ void stage_keys(const T* __restrict__ k,
                                           const T* __restrict__ v, int k0,
                                           int kend, float* kt, float* vt) {
  for (int e = threadIdx.x; e < KS * D; e += THREADS) {
    const int j = e / D;
    const int dd = e % D;
    const bool ok = k0 + j < kend;
    const size_t at = (size_t)(k0 + j) * D + dd;
    kt[dd * TSTRIDE + j] = ok ? to_f(k[at]) : 0.f;
    vt[dd * TSTRIDE + j] = ok ? to_f(v[at]) : 0.f;
  }
}

// The score phase of one (QS rows) x (KS keys) sub-tile: lane = key, the
// warp's RPW rows.  Writes P and dS of each (row, key) to ps / dss (0 for
// rows past rend, keys past kend, masked entries and dead rows).
template <typename T, int D, bool BAND>
__device__ __forceinline__ void scores(const BwdArgs<T>& a, bool full,
                                       const float* bias, int i, int c,
                                       int r0, int rend, int k0, int kend,
                                       const float* qs, const float* dos,
                                       const float* kt, const float* vt,
                                       const float* lse_s,
                                       const float* del_s, float* ps,
                                       float* dss) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float s[RPW], dp[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) s[r] = dp[r] = 0.f;
#pragma unroll 4
  for (int dd = 0; dd < D; ++dd) {
    const float kv = kt[dd * TSTRIDE + lane];
    const float vv = vt[dd * TSTRIDE + lane];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int rr = warp * RPW + r;
      s[r] = fmaf(qs[rr * D + dd], kv, s[r]);
      dp[r] = fmaf(dos[rr * D + dd], vv, dp[r]);
    }
  }
  const int key = k0 + lane;
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int rr = warp * RPW + r;
    const int row = r0 + rr;
    float p = 0.f, ds = 0.f;
    const float lse = lse_s[rr];
    if (row < rend && key < kend && lse != -INFINITY) {
      const float x =
          masked<T, BAND>(a, full, bias, i, c, row, key,
                          __fmul_rn(s[r], a.scale));
      p = expf(__fsub_rn(x, lse));
      ds = __fmul_rn(p, __fsub_rn(dp[r], del_s[rr]));
    }
    ps[rr * KS + lane] = p;
    dss[rr * KS + lane] = ds;
  }
}

template <int D>
constexpr size_t smem_bytes() {
  // kt, vt; qs, dos; ps, dss; lse_s, del_s
  return sizeof(float) *
         (2 * D * TSTRIDE + 2 * QS * D + 2 * QS * KS + 2 * QS);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    fa_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                        float* __restrict__ delta, long long rows) {
  const long long row = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float acc = 0.f;
#pragma unroll
  for (int u = 0; u < D / 32; ++u) {
    const size_t at = (size_t)row * D + lane + 32 * u;
    acc = fmaf(to_f(dout[at]), to_f(o[at]), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if (lane == 0) delta[row] = acc;
}

template <typename T, int D, bool BAND>
__global__ void __launch_bounds__(THREADS)
    fa_bwd_dkdv_kernel(BwdArgs<T> a) {
  constexpr int CPL = D / 32;
  extern __shared__ __align__(16) float sm[];
  float* kt = sm;
  float* vt = kt + D * TSTRIDE;
  float* qs = vt + D * TSTRIDE;
  float* dos = qs + QS * D;
  float* ps = dos + QS * D;
  float* dss = ps + QS * KS;
  float* lse_s = dss + QS * KS;
  float* del_s = lse_s + QS;

  const int nsub = (a.block_k + KS - 1) / KS;
  const int c = blockIdx.x / nsub;
  const int k0 = c * a.block_k + (blockIdx.x % nsub) * KS;
  const int kend = min(min((c + 1) * a.block_k, k0 + KS), a.lk);
  if (k0 >= kend) return;  // the whole CTA, before any barrier
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = a.hq / a.hkv;
  const size_t bhk = (size_t)b * a.hkv + hk;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  stage_keys<T, D>(a.k + bhk * a.lk * D, a.v + bhk * a.lk * D, k0, kend, kt,
                   vt);

  float dk_acc[KPW][CPL], dv_acc[KPW][CPL];
#pragma unroll
  for (int kk = 0; kk < KPW; ++kk)
#pragma unroll
    for (int u = 0; u < CPL; ++u) dk_acc[kk][u] = dv_acc[kk][u] = 0.f;

  const int cbeg = a.colp[c];
  const int cend = a.colp[c + 1];
  for (int hh = 0; hh < group; ++hh) {
    const size_t bh = (size_t)b * a.hq + hk * group + hh;
    for (int t = cbeg; t < cend; ++t) {
      const int i = a.colq[t];
      const int p = a.colt[t];
      const bool full = p < a.mid[i];
      const float* bias =
          (BAND || full) ? nullptr
                         : a.biases + (size_t)(a.prowp[i] + (p - a.mid[i])) *
                                          a.block_q * a.block_k;
      const int qtend = min((i + 1) * a.block_q, a.lq);
      for (int r0 = i * a.block_q; r0 < qtend; r0 += QS) {
        const int rend = min(r0 + QS, qtend);
        if (BAND && !full &&
            band_dead(a.causal, a.window, r0 + a.offset,
                      rend - 1 + a.offset, k0, kend - 1))
          continue;  // the same for every thread of the CTA
        __syncthreads();  // the last sub-tile's readers are done
        stage_rows<T, D>(a.q + bh * a.lq * D, a.dout + bh * a.lq * D,
                         a.lse + bh * a.lq, a.delta + bh * a.lq, r0, rend,
                         qs, dos, lse_s, del_s);
        __syncthreads();
        scores<T, D, BAND>(a, full, bias, i, c, r0, rend, k0, kend, qs, dos,
                           kt, vt, lse_s, del_s, ps, dss);
        __syncthreads();
        const int nrows = rend - r0;
        for (int r = 0; r < nrows; ++r) {
#pragma unroll
          for (int kk = 0; kk < KPW; ++kk) {
            const float pv = ps[r * KS + warp * KPW + kk];
            const float dsv = dss[r * KS + warp * KPW + kk];
#pragma unroll
            for (int u = 0; u < CPL; ++u) {
              const int col = lane + 32 * u;
              dv_acc[kk][u] = fmaf(pv, dos[r * D + col], dv_acc[kk][u]);
              dk_acc[kk][u] = fmaf(dsv, qs[r * D + col], dk_acc[kk][u]);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int kk = 0; kk < KPW; ++kk) {
    const int key = k0 + warp * KPW + kk;
    if (key >= kend) continue;
    const size_t at = (bhk * a.lk + key) * D;
#pragma unroll
    for (int u = 0; u < CPL; ++u) {
      a.dk[at + lane + 32 * u] =
          from_f<T>(__fmul_rn(dk_acc[kk][u], a.scale));
      a.dv[at + lane + 32 * u] = from_f<T>(dv_acc[kk][u]);
    }
  }
}

template <typename T, int D, bool BAND>
__global__ void __launch_bounds__(THREADS) fa_bwd_dq_kernel(BwdArgs<T> a) {
  constexpr int CPL = D / 32;
  extern __shared__ __align__(16) float sm[];
  float* kt = sm;
  float* vt = kt + D * TSTRIDE;
  float* qs = vt + D * TSTRIDE;
  float* dos = qs + QS * D;
  float* ps = dos + QS * D;
  float* dss = ps + QS * KS;
  float* lse_s = dss + QS * KS;
  float* del_s = lse_s + QS;

  const int nsub = (a.block_q + QS - 1) / QS;
  const int i = blockIdx.x / nsub;
  const int r0 = i * a.block_q + (blockIdx.x % nsub) * QS;
  const int rend = min(min((i + 1) * a.block_q, r0 + QS), a.lq);
  if (r0 >= rend) return;  // the whole CTA, before any barrier
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.hq / a.hkv);
  const size_t bh = (size_t)b * a.hq + h;
  const size_t bhk = (size_t)b * a.hkv + hk;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const T* kb = a.k + bhk * a.lk * D;
  const T* vb = a.v + bhk * a.lk * D;

  stage_rows<T, D>(a.q + bh * a.lq * D, a.dout + bh * a.lq * D,
                   a.lse + bh * a.lq, a.delta + bh * a.lq, r0, rend, qs, dos,
                   lse_s, del_s);

  float dq_acc[RPW][CPL];
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int u = 0; u < CPL; ++u) dq_acc[r][u] = 0.f;

  const int start = a.rowp[i];
  const int midp = a.mid[i];
  const int stop = a.rowp[i + 1];
  for (int p = start; p < stop; ++p) {
    const int c = a.cols[p];
    const bool full = p < midp;
    const float* bias =
        (BAND || full) ? nullptr
                       : a.biases + (size_t)(a.prowp[i] + (p - midp)) *
                                        a.block_q * a.block_k;
    const int ctend = min((c + 1) * a.block_k, a.lk);
    for (int k0 = c * a.block_k; k0 < ctend; k0 += KS) {
      const int kend = min(k0 + KS, ctend);
      if (BAND && !full &&
          band_dead(a.causal, a.window, r0 + a.offset, rend - 1 + a.offset,
                    k0, kend - 1))
        continue;  // the same for every thread of the CTA
      __syncthreads();  // the last sub-tile's readers are done
      stage_keys<T, D>(kb, vb, k0, kend, kt, vt);
      __syncthreads();
      scores<T, D, BAND>(a, full, bias, i, c, r0, rend, k0, kend, qs, dos,
                         kt, vt, lse_s, del_s, ps, dss);
      __syncthreads();
      const int nkeys = kend - k0;
      for (int j = 0; j < nkeys; ++j) {
        float kv[CPL];
#pragma unroll
        for (int u = 0; u < CPL; ++u) kv[u] = kt[(lane + 32 * u) * TSTRIDE + j];
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          const float dsv = dss[(warp * RPW + r) * KS + j];
#pragma unroll
          for (int u = 0; u < CPL; ++u)
            dq_acc[r][u] = fmaf(dsv, kv[u], dq_acc[r][u]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = r0 + warp * RPW + r;
    if (row >= rend) continue;
    const size_t at = (bh * a.lq + row) * D;
#pragma unroll
    for (int u = 0; u < CPL; ++u)
      a.dq[at + lane + 32 * u] = from_f<T>(__fmul_rn(dq_acc[r][u], a.scale));
  }
}

template <typename T, int D>
int launch_delta(const void* o, const void* dout, void* delta,
                 long long rows, cudaStream_t s) {
  const long long blocks = (rows + WARPS - 1) / WARPS;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  fa_bwd_delta_kernel<T, D><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<float*>(delta), rows);
  return static_cast<int>(cudaGetLastError());
}

// which = 0: dkdv over (nk * ceil(block_k / KS), Hkv, B); 1: dq over
// (nq * ceil(block_q / QS), Hq, B).
template <typename T, int D, bool BAND>
int launch_grad(const BwdArgs<T>& a, int batch, int which,
                cudaStream_t s) {
  const size_t bytes = smem_bytes<D>();
  if (which == 0) {
    const int nk = (a.lk + a.block_k - 1) / a.block_k;
    const dim3 grid(nk * ((a.block_k + KS - 1) / KS), a.hkv, batch);
    auto kernel = fa_bwd_dkdv_kernel<T, D, BAND>;
    cudaError_t err = fa::allow_smem(kernel, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, THREADS, bytes, s>>>(a);
  } else {
    const int nq = (a.lq + a.block_q - 1) / a.block_q;
    const dim3 grid(nq * ((a.block_q + QS - 1) / QS), a.hq, batch);
    auto kernel = fa_bwd_dq_kernel<T, D, BAND>;
    cudaError_t err = fa::allow_smem(kernel, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, THREADS, bytes, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_band(const BwdArgs<T>& a, int batch, bool band, int which,
                cudaStream_t s) {
  return band ? launch_grad<T, D, true>(a, batch, which, s)
              : launch_grad<T, D, false>(a, batch, which, s);
}

template <typename T>
int launch_dims(const BwdArgs<T>& a, int batch, int d, bool band, int which,
                cudaStream_t s) {
  switch (d) {
    case 32:
      return launch_band<T, 32>(a, batch, band, which, s);
    case 64:
      return launch_band<T, 64>(a, batch, band, which, s);
    case 96:
      return launch_band<T, 96>(a, batch, band, which, s);
    case 128:
      return launch_band<T, 128>(a, batch, band, which, s);
    case 256:
      return launch_band<T, 256>(a, batch, band, which, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_delta_dims(const void* o, const void* dout, void* delta,
                      long long rows, int d, cudaStream_t s) {
  switch (d) {
    case 32:
      return launch_delta<T, 32>(o, dout, delta, rows, s);
    case 64:
      return launch_delta<T, 64>(o, dout, delta, rows, s);
    case 96:
      return launch_delta<T, 96>(o, dout, delta, rows, s);
    case 128:
      return launch_delta<T, 128>(o, dout, delta, rows, s);
    case 256:
      return launch_delta<T, 256>(o, dout, delta, rows, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
BwdArgs<T> args(const void* rowp, const void* mid, const void* prowp,
                const void* cols, const void* biases, const void* colp,
                const void* colq, const void* colt, const void* q,
                const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, void* dq, void* dk,
                void* dv, int hq, int hkv, int lq, int lk, int block_q,
                int block_k, int causal, int window, int offset,
                float scale) {
  return BwdArgs<T>{static_cast<const int*>(rowp),
                    static_cast<const int*>(mid),
                    static_cast<const int*>(prowp),
                    static_cast<const int*>(cols),
                    static_cast<const float*>(biases),
                    static_cast<const int*>(colp),
                    static_cast<const int*>(colq),
                    static_cast<const int*>(colt),
                    static_cast<const T*>(q),
                    static_cast<const T*>(k),
                    static_cast<const T*>(v),
                    static_cast<const T*>(dout),
                    static_cast<const float*>(lse),
                    static_cast<const float*>(delta),
                    static_cast<T*>(dq),
                    static_cast<T*>(dk),
                    static_cast<T*>(dv),
                    hq, hkv, lq, lk, block_q, block_k,
                    causal, window, offset, scale};
}

int grad_launch(int which, const void* rowp, const void* mid,
                const void* prowp, const void* cols, const void* biases,
                const void* colp, const void* colq, const void* colt,
                const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* dq, void* dk, void* dv, int batch, int hq, int hkv,
                int lq, int lk, int d, int block_q, int block_k, int band,
                int causal, int window, int offset, float scale, int dtype,
                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block_k < 1 || block_k > fa::BK_MAX || block_q < 1 || hkv < 1 ||
      hq % hkv || batch > 65535 || hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_dims<float>(
        args<float>(rowp, mid, prowp, cols, biases, colp, colq, colt, q, k, v,
                    dout, lse, delta, dq, dk, dv, hq, hkv, lq, lk, block_q,
                    block_k, causal, window, offset, scale),
        batch, d, band != 0, which, s);
  if (dtype == 1)
    return launch_dims<__nv_bfloat16>(
        args<__nv_bfloat16>(rowp, mid, prowp, cols, biases, colp, colq, colt,
                            q, k, v, dout, lse, delta, dq, dk, dv, hq, hkv,
                            lq, lk, block_q, block_k, causal, window, offset,
                            scale),
        batch, d, band != 0, which, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// o, dout (rows, d) contiguous in dtype (0 = f32, 1 = bf16); delta (rows,)
// f32.  d in {32, 64, 96, 128, 256}.
extern "C" int fa_bwd_delta_launch(const void* o, const void* dout,
                                   void* delta, long long rows, int d,
                                   int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 1) return 0;
  if (dtype == 0)
    return launch_delta_dims<float>(o, dout, delta, rows, d, s);
  if (dtype == 1)
    return launch_delta_dims<__nv_bfloat16>(o, dout, delta, rows, d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The layout arrays of flash_attention_tiles_launch (rowp, mid, prowp,
// cols, biases) and its transpose: colp (nk + 1), colq and colt (ntiles),
// column c's walk entries t in colp[c] .. colp[c+1], each the Q tile
// colq[t] and its row-walk index colt[t], ascending in Q tile.  q, dout
// (B, Hq, Lq, d) and k, v (B, Hkv, Lk, d) in dtype; lse and delta (B, Hq,
// Lq) f32, lse = -inf on rows with no live key.  dkdv writes dk, dv (like
// k); dq writes dq (like q).  The caller checks what
// flash_attention_tiles_launch's caller checks.
extern "C" int fa_bwd_dkdv_launch(
    const void* rowp, const void* mid, const void* prowp, const void* cols,
    const void* biases, const void* colp, const void* colq, const void* colt,
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int batch,
    int hq, int hkv, int lq, int lk, int d, int block_q, int block_k,
    int band, int causal, int window, int offset, float scale, int dtype,
    void* stream) {
  return grad_launch(0, rowp, mid, prowp, cols, biases, colp, colq, colt, q,
                     k, v, dout, lse, delta, nullptr, dk, dv, batch, hq, hkv,
                     lq, lk, d, block_q, block_k, band, causal, window,
                     offset, scale, dtype, stream);
}

extern "C" int fa_bwd_dq_launch(
    const void* rowp, const void* mid, const void* prowp, const void* cols,
    const void* biases, const void* q, const void* k, const void* v,
    const void* dout, const void* lse, const void* delta, void* dq,
    int batch, int hq, int hkv, int lq, int lk, int d, int block_q,
    int block_k, int band, int causal, int window, int offset, float scale,
    int dtype, void* stream) {
  return grad_launch(1, rowp, mid, prowp, cols, biases, nullptr, nullptr,
                     nullptr, q, k, v, dout, lse, delta, dq, nullptr,
                     nullptr, batch, hq, hkv, lq, lk, d, block_q, block_k,
                     band, causal, window, offset, scale, dtype, stream);
}
