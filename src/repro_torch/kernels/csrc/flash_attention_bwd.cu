// The backward of tile-skipping flash attention (FlashAttention-2's
// backward), in CUDA for sm_90a: f32 or bf16 q, k, v, o, dO; f32 lse, D and
// accumulators; dQ, dK, dV in the input type.  The JAX package has no
// backward kernel (it differentiates through its XLA plane); these kernels
// are the port's own, and walk the same TileLayout as the forward
// (flash_attention_tiles.cu), with the same masks:
//
//   fa_bwd_delta_kernel  D[row] = sum_d dO[row, d] * O[row, d], one warp a
//                        row.
//   dK / dV              one CTA per (a part of a K tile, kv head, b).  It
//                        walks the K tile's column of the layout (the Q
//                        tiles that see it, ascending, from the transposed
//                        layout colp / colq / colt), for each q head of the
//                        GQA group in order, in sub-tiles of Q rows, and
//                        accumulates
//                          dV += P^T dO,  dK += dS^T q * scale
//                        with P = exp(S - lse), dP = dO V^T and
//                        dS = P * (dP - D).  dK and dV are written once: no
//                        atomics, and the GQA sum over heads is a fixed
//                        sum, the same bits from run to run.
//   dQ                   one CTA per (a part of a Q tile, q head, b).  It
//                        walks the Q tile's row of the layout (the
//                        forward's rowp / cols), in sub-tiles of keys, and
//                        accumulates dQ += dS K * scale.  No atomics.
//
// S = (q . k) * scale, masked as the forward masks it: FULL tiles not at
// all; PARTIAL tiles by the band compare (template BAND: causal, window,
// offset) or by adding their stored bias tile
// biases[prowp[i] + (p - mid[i])].  lse = m + log(l) of the forward's state
// (f32), and -inf for a row with no live key (m == NEG_INF): such a row has
// P = 0, so it adds nothing to dK and dV and its dQ is 0.  A sub-tile that
// the band masks whole is skipped (its P is 0).
//
// Bound on this card: dK/dV does 8 and dQ 6 flops a live (row, key) pair
// and d (S and dP are recomputed in both), so at the training shape (B 4,
// Hq 16, L 512 causal, d 128) 8.6 and 6.4 GFLOP: 8.7 and 6.5 us at the
// bf16 tensor-core rate, 130 and 100 us at the f32 FMA peak, against
// 10 us for each kernel's own bytes.  So the products must run on the
// tensor cores, through wgmma.  Each dtype has its own pair of kernels:
//
// bf16: fa_bwd_dkdv_wgmma_kernel and fa_bwd_dq_wgmma_kernel run every
// product on wgmma with bf16 operands, each of the forward's two shapes
// (flash_attention_wgmma.cuh):
//   score-shaped  both operands K-major in shared memory, reduced over d,
//                 m64n64k16: S^T = K q^T and dP^T = V dO^T (dK/dV),
//                 S = q K^T and dP = dO V^T (dQ);
//   value-shaped  A from registers (the last product's accumulators, P or
//                 dS rounded to bf16, round to nearest even), B row-major
//                 [reduction x d] in shared memory read as the transposed
//                 operand, m64n{d}k16: dV += P^T dO, dK += dS^T q (dK/dV),
//                 dQ += dS K (dQ).  At d = 112 a row is 14 column blocks
//                 of 8, so the score products take 7 k16 steps, the value
//                 products run m64n112k16 and the TMA box is (8, 64, 14).
// A warpgroup owns 64 keys (dK/dV) or 64 rows (dQ): wgmma's M.  The CTA's
// own operand (K and V, or q and dO) is staged once by cp.async; the walked
// sub-tiles, 64 rows (dK/dV: q and dO, with lse and D) or 64 keys (dQ: K
// and V), pass through a ring of RING stages, the next loading while this
// one is computed: a whole sub-tile by the TMA (one thread issues a 3-d
// copy that lands in wgmma's layout and completes on the stage's
// mbarrier), a sub-tile cut by a tile's edge by cp.async with zeros past
// the edge.  Everything is staged in wgmma's layout without swizzle
// (tc::load_rows), so one buffer serves as the K-major operand of a
// score-shaped product and the transposed operand of a value-shaped one.
// The mask, P = exp2(S * scale * log2(e) - lse * log2(e)) and dS run on
// the accumulators in registers (FULL tiles without a compare), entries
// past a sub-tile's edge drop out (P = dS = 0), and dK, dV and dQ stay in
// f32 registers and are written once.  At d = 256 dK plus dV would be 256
// accumulators a thread, so two warpgroups share a CTA's 64 keys, each
// owning 128 of dK's and dV's columns and each computing S^T and dP^T in
// full (the score products run twice).  The CTAs of the heaviest columns
// (dK/dV) and rows (dQ) start first (the order arrays).  What holds the
// kernels back on this card (PERF.md has the times): the score products
// read both operands from shared memory, whose bandwidth they saturate;
// the warpgroups run the products, the mask and the softmax in step, so
// the tensor cores idle during the elementwise work; and causal columns
// are unequal, so a dK/dV CTA of column 0 walks four times the units of
// the last column's.
//
// f32: fa_bwd_dkdv_kernel and fa_bwd_dq_kernel keep the products on the
// FMA units in f32 (TF32 would change their numbers).  Shared memory holds
// 32 x 32 sub-tiles: K and V transposed (kt[d][key], stride KS + 1, so
// that lanes reading neighbouring keys and threads writing neighbouring d
// hit different banks), q and dO row-major, all f32; about 140 KB at
// d = 256.  In the score phase lane l owns key l of the sub-tile and a
// warp RPW rows; in the accumulate phase lane l owns columns l, l + 32,
// ... (ceil(D / 32) of them: at d = 112 lanes 0-15 own a fourth, as in the
// forward's fa::State) and a warp KS / WARPS keys (dK/dV) or RPW rows (dQ).
// The delta kernel gives a lane the same columns.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <limits.h>
#include <math.h>

#include <type_traits>

#include "flash_attention_wgmma.cuh"

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
  const int* order;     // the bf16 kernels' tiles, heaviest first: K tiles
                        // (dK/dV) or Q tiles (dQ)
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

// True when the band keeps global row ``row`` and global key ``key``.
template <typename T>
__device__ __forceinline__ bool band_live(const BwdArgs<T>& a, int row,
                                          int key) {
  const int qb = row + a.offset;
  bool live = true;
  if (a.causal) live = qb >= key;
  if (a.window >= 0)
    live = live && (a.causal ? qb - key < a.window
                             : abs(qb - key) < a.window);
  return live;
}

// The masked score of global row ``row`` (in Q tile i) and global key
// ``key`` (in K tile c), as the forward computes it.
template <typename T, bool BAND>
__device__ __forceinline__ float masked(const BwdArgs<T>& a, bool full,
                                        const float* bias, int i, int c,
                                        int row, int key, float x) {
  if (full) return x;
  if (BAND) return band_live(a, row, key) ? x : fa::NEG_INF;
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
  for (int u = 0; u < fa::State<D>::CPL; ++u) {
    if (!fa::State<D>::owns(lane, u)) continue;
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
  constexpr int CPL = fa::State<D>::CPL;  // ceil(D / 32) columns a lane
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
              if (!fa::State<D>::owns(lane, u)) continue;
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
      if (!fa::State<D>::owns(lane, u)) continue;
      a.dk[at + lane + 32 * u] =
          from_f<T>(__fmul_rn(dk_acc[kk][u], a.scale));
      a.dv[at + lane + 32 * u] = from_f<T>(dv_acc[kk][u]);
    }
  }
}

template <typename T, int D, bool BAND>
__global__ void __launch_bounds__(THREADS) fa_bwd_dq_kernel(BwdArgs<T> a) {
  constexpr int CPL = fa::State<D>::CPL;  // ceil(D / 32) columns a lane
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
        for (int u = 0; u < CPL; ++u)
          kv[u] = fa::State<D>::owns(lane, u)
                      ? kt[(lane + 32 * u) * TSTRIDE + j]
                      : 0.f;
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
      if (fa::State<D>::owns(lane, u))
        a.dq[at + lane + 32 * u] = from_f<T>(__fmul_rn(dq_acc[r][u], a.scale));
  }
}

// -- bf16: the tensor-core kernels -------------------------------------------

using tc::bf16;

constexpr int TS = 64;        // rows or keys of a walked sub-tile; wgmma's M
constexpr int RING = 2;       // stages of the walked sub-tiles' ring

// 4 bytes global -> shared, or 4 zero bytes when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   tc::smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Warpgroups of a bf16 CTA and the keys (dK/dV) or rows (dQ) it owns.  A
// warpgroup owns 64 of them, or at d = 256 (dK/dV) two warpgroups share 64
// and split d.
inline int dkdv_wgs(int d, int block_k) {
  return d > 128 ? 2 : (block_k > TS ? 2 : 1);
}
inline int dkdv_keys(int d, int block_k) {
  return d > 128 ? TS : TS * dkdv_wgs(d, block_k);
}
inline int dq_wgs(int d, int block_q) {
  return d > 128 ? 1 : (block_q > TS ? 2 : 1);
}

// Dynamic shared memory: the CTA's own operand (K and V of kc keys, or q
// and dO of kc rows), then RING stages of the walked sub-tiles: q, dO, lse
// and D of TS rows, or K and V of TS keys, and the unit's UnitMeta, each
// stage 128-byte aligned (the TMA's destinations).  dK/dV: 193 KiB at
// d = 256, 129 KiB at d = 128; dQ: 192 KiB and 128 KiB.
__host__ __device__ inline size_t dkdv_stage_bytes(int d) {
  return 2 * TS * d * sizeof(bf16) + 640;  // lse, D, UnitMeta: 544 bytes
}
__host__ __device__ inline size_t dq_stage_bytes(int d) {
  return 2 * TS * d * sizeof(bf16) + 128;  // UnitMeta: 32 bytes
}

// The TMA copies of whole sub-tiles (TS rows or keys): a 3-d map of a
// (rows, d) bf16 row-major matrix, dims (8 values, rows, d / 8 column
// blocks), strides (d * 2, 16) bytes, box (8, TS, d / 8), whose box lands
// in shared memory in tc::load_rows's layout (column block c of row r at
// byte c * TS * 16 + r * 16).  The TMA engine moves the 16-byte chunks
// that cp.async would move one instruction at a time.
inline cudaError_t rows_map(CUtensorMap* map, const void* base,
                            long long rows, int d) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    void* fn = nullptr;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess) return cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint64_t dims[3] = {8, static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(d / 8)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2, 16};
  const cuuint32_t box[3] = {8, TS, static_cast<cuuint32_t>(d / 8)};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
      dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A stage's mbarrier, one arrival (the thread that issues its copies)
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   tc::smem_u32(bar))
               : "memory");
}

// The issuing thread's arrival on *bar, expecting `bytes` from the TMA
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "fence.proxy.async.shared::cta;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          tc::smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// Rows [row, row + TS) of `map` into dst (128-byte aligned), their bytes
// counted on *bar
__device__ __forceinline__ void tma_rows(void* dst, const CUtensorMap* map,
                                         int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(tc::smem_u32(dst)),
      "l"(map), "r"(0), "r"(row), "r"(0), "r"(tc::smem_u32(bar))
      : "memory");
}

// Wait until *bar completed the phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(tc::smem_u32(bar)), "r"(parity)
        : "memory");
}

constexpr float LOG2E = 1.4426950408889634f;

// One unit of a dK/dV CTA's walk: q head hh of the GQA group, column entry
// t (Q tile i = colq[t], its walk index p = colt[t], FULL or not), the
// TS-row sub-tile [r0, rend) (r0 < 0: the Q tile's first, not yet read).
// Units run hh-major, then t, then r0; ``col_settle`` moves u to the first
// unit at or after it that the band does not mask whole for keys [klo,
// khi] (past the last: hh == group).  Every thread walks the same units.
struct ColUnit {
  int hh, t, r0;
  int i, p, full, rend;
};

template <bool BAND>
__device__ __forceinline__ ColUnit col_settle(const BwdArgs<bf16>& a,
                                              ColUnit u, int group, int cbeg,
                                              int cend, int klo, int khi) {
  while (u.hh < group) {
    if (u.t >= cend) {
      ++u.hh;
      u.t = cbeg;
      u.r0 = -1;
      continue;
    }
    if (u.r0 < 0) {
      u.i = __ldg(a.colq + u.t);
      u.p = __ldg(a.colt + u.t);
      u.full = u.p < __ldg(a.mid + u.i);
      u.r0 = u.i * a.block_q;
    }
    const int qtend = min((u.i + 1) * a.block_q, a.lq);
    if (u.r0 >= qtend) {
      ++u.t;
      u.r0 = -1;
      continue;
    }
    u.rend = min(u.r0 + TS, qtend);
    if (BAND && !u.full &&
        band_dead(a.causal, a.window, u.r0 + a.offset,
                  u.rend - 1 + a.offset, klo, khi)) {
      u.r0 += TS;
      continue;
    }
    break;
  }
  return u;
}

// One unit of a dQ CTA's walk: walk entry p (K tile c = cols[p], FULL or
// not), the TS-key sub-tile [k0, kend) (k0 < 0: the K tile's first, not yet
// read), skipping sub-tiles the band masks whole for rows [qlo, qhi] (past
// the last: p == stop).
struct RowUnit {
  int p, k0;
  int c, full, kend;
};

template <bool BAND>
__device__ __forceinline__ RowUnit row_settle(const BwdArgs<bf16>& a,
                                              RowUnit u, int midp, int stop,
                                              int qlo, int qhi) {
  while (u.p < stop) {
    if (u.k0 < 0) {
      u.c = __ldg(a.cols + u.p);
      u.full = u.p < midp;
      u.k0 = u.c * a.block_k;
    }
    const int ctend = min((u.c + 1) * a.block_k, a.lk);
    if (u.k0 >= ctend) {
      ++u.p;
      u.k0 = -1;
      continue;
    }
    u.kend = min(u.k0 + TS, ctend);
    if (BAND && !u.full &&
        band_dead(a.causal, a.window, qlo + a.offset, qhi + a.offset, u.k0,
                  u.kend - 1)) {
      u.k0 += TS;
      continue;
    }
    break;
  }
  return u;
}

// What the compute of a stage's unit needs, written by thread 0 when the
// stage is issued: ok (0 past the walk's end), then the unit's Q tile (dK/dV)
// or K tile (dQ), its walk index p, its sub-tile's first and end row (or
// key), whether its tile is FULL, and whether its sub-tile is whole (TS
// rows or keys: the TMA copied it, and it completes on the stage's
// mbarrier; else cp.async did, zero past the edge).
struct UnitMeta {
  int ok, tile, p, lo, hi, full, tma;
};

// The bias tile of walk entry p of Q tile i (a PARTIAL tile of a layout
// without a band), else nullptr.
template <bool BAND>
__device__ __forceinline__ const float* bias_of(const BwdArgs<bf16>& a,
                                                int i, int p, bool full) {
  if (BAND || full) return nullptr;
  return a.biases +
         (size_t)(a.prowp[i] + (p - a.mid[i])) * a.block_q * a.block_k;
}

// -lse * log2(e), and -inf for a row with no live key or past the
// sub-tile's edge (live false), so that P = exp2(s * scale * log2(e) +
// that) is 0 on such a row
__device__ __forceinline__ float neg_lse2(float lse, bool live) {
  return live && lse != -INFINITY ? -__fmul_rn(lse, LOG2E) : -INFINITY;
}

// An accumulator entry's P and dS from its P: s becomes P and dp (dP)
// becomes dS = P * (dP - D)
__device__ __forceinline__ void p_ds(float pe, float del, float& s,
                                     float& dp) {
  dp = __fmul_rn(pe, __fsub_rn(dp, del));
  s = pe;
}

// The band as an interval of row - key: an entry is live iff lo <= row -
// key <= hi (band_live's test with the offset folded in), two compares.
struct Band {
  int lo, hi;
  __device__ __forceinline__ bool live(int row, int key) const {
    return row - key >= lo && row - key <= hi;
  }
};

__device__ __forceinline__ Band band_of(const BwdArgs<bf16>& a) {
  int lo = INT_MIN / 2, hi = INT_MAX / 2;
  if (a.causal) lo = 0;
  if (a.window >= 0) {
    hi = a.window - 1;
    if (!a.causal) lo = 1 - a.window;
  }
  return Band{lo - a.offset, hi - a.offset};
}

// P of a PARTIAL entry from its argument x (s * scale * log2(e) - lse *
// log2(e)): exp2(x) where the band keeps it, else 0, or with a bias tile
// exp2(x + bias * log2(e)) (the tile's row tr, key tk); 0 where the entry
// is past the sub-tile's edge (ok false)
template <bool BAND>
__device__ __forceinline__ float p_masked(const BwdArgs<bf16>& a, Band band,
                                          const float* bias, int tr, int tk,
                                          int row, int key, bool ok,
                                          float x) {
  if (BAND) {
    const float pe = exp2f(x);
    return ok && band.live(row, key) ? pe : 0.f;
  }
  if (!ok) return 0.f;
  return exp2f(fmaf(bias[tr * a.block_k + tk], LOG2E, x));
}

// 32 accumulators of an m64n64 product as the register A operand of four
// k16 steps, rounded to bf16
__device__ __forceinline__ void pack_a(const float (&x)[32],
                                       uint32_t (&a)[4][4]) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    a[m][0] = tc::pack(x[8 * m], x[8 * m + 1]);
    a[m][1] = tc::pack(x[8 * m + 2], x[8 * m + 3]);
    a[m][2] = tc::pack(x[8 * m + 4], x[8 * m + 5]);
    a[m][3] = tc::pack(x[8 * m + 6], x[8 * m + 7]);
  }
}

// dK and dV of one CTA: keys [k0, kend) of K tile order[..] (kc keys,
// dkdv_keys), for one (b, kv head); blockIdx.x runs the kv head fastest,
// then b, then the K tile's place in ``order``.  blockDim.x is 128 x
// dkdv_wgs.  In an accumulator of a warpgroup (S^T, dP^T: keys x rows;
// dK, dV: keys x columns), lane (g = lane / 4, tq = lane % 4) of its warp
// w4 holds keys 16 w4 + g and 16 w4 + g + 8 and columns 8j + 2tq and
// 8j + 2tq + 1 of each block j of 8 in registers 4j .. 4j + 3.  A stage
// holds q and dO (TS x D each, tc::load_rows's layout), lse and D (TS f32
// each) and the unit's UnitMeta.
template <int D, bool BAND>
__global__ void __launch_bounds__(tc::THREADS_MAX, 1)
    fa_bwd_dkdv_wgmma_kernel(BwdArgs<bf16> a, int batch,
                             const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_do) {
  constexpr bool SPLIT = D > 128;  // two warpgroups split d
  constexpr int DH = SPLIT ? D / 2 : D;  // dK, dV columns of a warpgroup
  constexpr int KD = D / 16;             // k16 steps over d
  extern __shared__ __align__(128) unsigned char smem_bwd[];
  __shared__ uint64_t bars[RING];  // a stage's TMA copies complete here
  const int kc = SPLIT ? TS : TS * (int)(blockDim.x / 128);
  const int nsub = (a.block_k + kc - 1) / kc;
  int id = blockIdx.x;
  const int hk = id % a.hkv;
  id /= a.hkv;
  const int b = id % batch;
  id /= batch;
  const int c = a.order[id / nsub];
  const int k0 = c * a.block_k + (id % nsub) * kc;
  const int kend = min(min((c + 1) * a.block_k, k0 + kc), a.lk);
  if (k0 >= kend) return;  // the whole CTA, before any barrier
  const int group = a.hq / a.hkv;
  const size_t bhk = (size_t)b * a.hkv + hk;

  bf16* k_s = reinterpret_cast<bf16*>(smem_bwd);
  bf16* v_s = k_s + (size_t)kc * D;
  unsigned char* stages =
      reinterpret_cast<unsigned char*>(v_s + (size_t)kc * D);
  const size_t stage_bytes = dkdv_stage_bytes(D);

  tc::load_rows<D>(k_s, a.k + (bhk * a.lk + k0) * D, kc, kc, kend - k0);
  tc::load_rows<D>(v_s, a.v + (bhk * a.lk + k0) * D, kc, kc, kend - k0);
  tc::cp_commit();
  if (threadIdx.x == 0) {
    for (int st = 0; st < RING; ++st) mbar_init(bars + st);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  const int cbeg = a.colp[c];
  const int cend = a.colp[c + 1];
  // unit u into stage st: q and dO by the TMA (a whole sub-tile) or by
  // cp.async, lse and D by cp.async, one group (an empty group past the
  // walk keeps the count of pending groups fixed), and its UnitMeta
  auto issue = [&](const ColUnit& u, int st) {
    unsigned char* base = stages + st * stage_bytes;
    bf16* qs = reinterpret_cast<bf16*>(base);
    float* ls = reinterpret_cast<float*>(qs + 2 * TS * D);
    UnitMeta* meta = reinterpret_cast<UnitMeta*>(ls + 2 * TS);
    const int rows = u.rend - u.r0;
    if (u.hh < group) {
      const size_t row0 =
          ((size_t)b * a.hq + hk * group + u.hh) * a.lq + u.r0;
      if (rows < TS) {
        tc::load_rows<D>(qs, a.q + row0 * D, TS, TS, rows);
        tc::load_rows<D>(qs + TS * D, a.dout + row0 * D, TS, TS, rows);
      } else if (threadIdx.x == 0) {
        mbar_expect(bars + st, 2 * TS * D * sizeof(bf16));
        tma_rows(qs, &tm_q, static_cast<int>(row0), bars + st);
        tma_rows(qs + TS * D, &tm_do, static_cast<int>(row0), bars + st);
      }
      for (int e = threadIdx.x; e < TS; e += blockDim.x) {
        const bool ok = e < rows;
        cp_async4(ls + e, a.lse + row0 + (ok ? e : 0), ok);
        cp_async4(ls + TS + e, a.delta + row0 + (ok ? e : 0), ok);
      }
    }
    if (threadIdx.x == 0)
      *meta = UnitMeta{u.hh < group, u.i, u.p, u.r0, u.rend, u.full,
                       u.hh < group && rows == TS};
    tc::cp_commit();
  };

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int kw0 = k0 + (SPLIT ? 0 : wg * TS);  // the warpgroup's keys
  const int kwend = min(kend, kw0 + TS);
  const bool wlive = kw0 < kend;               // uniform over the warpgroup
  const int col0 = SPLIT ? wg * DH : 0;        // its dK, dV columns
  const int key0 = kw0 + (threadIdx.x / 32 % 4) * 16 + g;
  const float c2 = __fmul_rn(a.scale, LOG2E);
  const Band band = band_of(a);
  // K and V of the warpgroup's keys as the K-major A operand; a k16 step is
  // two column blocks on
  const uint64_t ak = tc::desc(k_s + (kw0 - k0) * 8, kc * 16, 128);
  const uint64_t av = tc::desc(v_s + (kw0 - k0) * 8, kc * 16, 128);

  float dk[DH / 2], dv[DH / 2];
#pragma unroll
  for (int j = 0; j < DH / 2; ++j) dk[j] = dv[j] = 0.f;

  ColUnit ld = col_settle<BAND>(a, ColUnit{0, cbeg, -1, 0, 0, 0, 0}, group,
                                cbeg, cend, k0, kend - 1);
  auto advance = [&]() {
    if (ld.hh < group) {
      ld.r0 += TS;
      ld = col_settle<BAND>(a, ld, group, cbeg, cend, k0, kend - 1);
    }
  };
  uint32_t parity = 0;  // bit st: the parity of stage st's next TMA phase
  for (int s = 0; s < RING - 1; ++s) {
    issue(ld, s);
    advance();
  }
  for (int n = 0;; ++n) {
    issue(ld, (n + RING - 1) % RING);
    advance();
    tc::cp_wait<RING - 1>();  // K, V and unit n's cp.async copies landed
    __syncthreads();
    const bf16* qs =
        reinterpret_cast<const bf16*>(stages + (n % RING) * stage_bytes);
    const bf16* dos = qs + TS * D;
    const float* lse_s = reinterpret_cast<const float*>(dos + TS * D);
    const float* del_s = lse_s + TS;
    const UnitMeta u = *reinterpret_cast<const UnitMeta*>(del_s + TS);
    if (!u.ok) break;  // the same for every thread of the CTA
    if (u.tma) {
      mbar_wait(bars + n % RING, (parity >> (n % RING)) & 1);
      parity ^= 1u << (n % RING);
    }
    const int i = u.tile;
    const int r0 = u.lo;
    const int rend = u.hi;
    const bool live =
        wlive && !(BAND && !u.full &&
                   band_dead(a.causal, a.window, r0 + a.offset,
                             rend - 1 + a.offset, kw0, kwend - 1));
    if (live) {
      // S^T = K q^T and dP^T = V dO^T: q and dO are the K-major B operand
      float st[32], dpt[32];
      const uint64_t bq = tc::desc(qs, TS * 16, 128);
      const uint64_t bdo = tc::desc(dos, TS * 16, 128);
      tc::wg_fence();
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        tc::wgmma_ss_n64(st, ak + kk * (2 * kc), bq + kk * (2 * TS), kk > 0);
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        tc::wgmma_ss_n64(dpt, av + kk * (2 * kc), bdo + kk * (2 * TS),
                         kk > 0);
      tc::wg_commit_wait();
      // P^T and dS^T in place; the entry e of a thread is key key0 +
      // 8 ((e >> 1) & 1), row r0 + rr of the unit
      if (u.full) {
        // no mask; keys past kwend only reach their own (unwritten) rows
        // of dK and dV, and rows past rend have P = 0
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int rr = 8 * (e >> 2) + 2 * tq + (e & 1);
          p_ds(exp2f(fmaf(st[e], c2, neg_lse2(lse_s[rr], r0 + rr < rend))),
               del_s[rr], st[e], dpt[e]);
        }
      } else {
        const float* bias = bias_of<BAND>(a, i, u.p, false);
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int key = key0 + 8 * ((e >> 1) & 1);
          const int rr = 8 * (e >> 2) + 2 * tq + (e & 1);
          const int row = r0 + rr;
          const float x = fmaf(st[e], c2, neg_lse2(lse_s[rr], row < rend));
          p_ds(p_masked<BAND>(a, band, bias, row - i * a.block_q,
                              key - c * a.block_k, row, key,
                              row < rend && key < kwend, x),
               del_s[rr], st[e], dpt[e]);
        }
      }
      // dV += P^T dO and dK += dS^T q: P^T and dS^T (bf16) are the register
      // A operand, dO and q the transposed B operand (rows along K); a k16
      // step is two row blocks on
      uint32_t pa[4][4], da[4][4];
      pack_a(st, pa);
      pack_a(dpt, da);
      const uint64_t vdo = tc::desc(dos + col0 * TS, 128, TS * 16);
      const uint64_t vq = tc::desc(qs + col0 * TS, 128, TS * 16);
      tc::wg_fence();
#pragma unroll
      for (int m = 0; m < 4; ++m) tc::wgmma_pv<DH>(dv, pa[m], vdo + m * 16);
#pragma unroll
      for (int m = 0; m < 4; ++m) tc::wgmma_pv<DH>(dk, da[m], vq + m * 16);
      tc::wg_commit_wait();
    }
    __syncthreads();  // the stage is free for the unit that reuses it
  }
  tc::cp_wait<0>();  // the empty groups past the walk

  if (!wlive) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= kwend) continue;
    const size_t at = (bhk * a.lk + key) * D + col0 + 2 * tq;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(a.dk + at + 8 * j) =
          __floats2bfloat162_rn(__fmul_rn(dk[4 * j + 2 * r], a.scale),
                                __fmul_rn(dk[4 * j + 2 * r + 1], a.scale));
      *reinterpret_cast<__nv_bfloat162*>(a.dv + at + 8 * j) =
          __floats2bfloat162_rn(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
    }
  }
}

// dQ of one CTA: rows [r0, rend) of Q tile order[..] (64 x dq_wgs rows),
// for one (b, q head); blockIdx.x runs the q head fastest, then b, then
// the Q tile's place in ``order``.  blockDim.x is 128 x dq_wgs.  In an
// accumulator of a warpgroup (S, dP: rows x keys; dQ: rows x columns),
// lane (g, tq) of its warp w4 holds rows 16 w4 + g and 16 w4 + g + 8.  A
// stage holds K and V (TS x D each) and the unit's UnitMeta.
template <int D, bool BAND>
__global__ void __launch_bounds__(tc::THREADS_MAX, 1)
    fa_bwd_dq_wgmma_kernel(BwdArgs<bf16> a, int batch,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v) {
  constexpr int KD = D / 16;
  extern __shared__ __align__(128) unsigned char smem_bwd[];
  __shared__ uint64_t bars[RING];  // a stage's TMA copies complete here
  const int qc = TS * (int)(blockDim.x / 128);
  const int nsub = (a.block_q + qc - 1) / qc;
  int id = blockIdx.x;
  const int h = id % a.hq;
  id /= a.hq;
  const int b = id % batch;
  id /= batch;
  const int i = a.order[id / nsub];
  const int r0 = i * a.block_q + (id % nsub) * qc;
  const int rend = min(min((i + 1) * a.block_q, r0 + qc), a.lq);
  if (r0 >= rend) return;  // the whole CTA, before any barrier
  const int hk = h / (a.hq / a.hkv);
  const size_t bh = (size_t)b * a.hq + h;
  const size_t bhk = (size_t)b * a.hkv + hk;

  bf16* q_s = reinterpret_cast<bf16*>(smem_bwd);
  bf16* do_s = q_s + (size_t)qc * D;
  unsigned char* stages =
      reinterpret_cast<unsigned char*>(do_s + (size_t)qc * D);
  const size_t stage_bytes = dq_stage_bytes(D);

  tc::load_rows<D>(q_s, a.q + (bh * a.lq + r0) * D, qc, qc, rend - r0);
  tc::load_rows<D>(do_s, a.dout + (bh * a.lq + r0) * D, qc, qc, rend - r0);
  tc::cp_commit();
  if (threadIdx.x == 0) {
    for (int st = 0; st < RING; ++st) mbar_init(bars + st);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  const int start = a.rowp[i];
  const int midp = a.mid[i];
  const int stop = a.rowp[i + 1];
  // unit u into stage st: K and V by the TMA (a whole sub-tile) or by
  // cp.async, one group (empty past the walk), and its UnitMeta
  auto issue = [&](const RowUnit& u, int st) {
    bf16* ks = reinterpret_cast<bf16*>(stages + st * stage_bytes);
    UnitMeta* meta = reinterpret_cast<UnitMeta*>(ks + 2 * TS * D);
    const int keys = u.kend - u.k0;
    if (u.p < stop) {
      const size_t key0 = bhk * a.lk + u.k0;
      if (keys < TS) {
        tc::load_rows<D>(ks, a.k + key0 * D, TS, TS, keys);
        tc::load_rows<D>(ks + TS * D, a.v + key0 * D, TS, TS, keys);
      } else if (threadIdx.x == 0) {
        mbar_expect(bars + st, 2 * TS * D * sizeof(bf16));
        tma_rows(ks, &tm_k, static_cast<int>(key0), bars + st);
        tma_rows(ks + TS * D, &tm_v, static_cast<int>(key0), bars + st);
      }
    }
    if (threadIdx.x == 0)
      *meta = UnitMeta{u.p < stop, u.c, u.p, u.k0, u.kend, u.full,
                       u.p < stop && keys == TS};
    tc::cp_commit();
  };

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int wr0 = r0 + wg * TS;  // the warpgroup's rows
  const int wrend = min(rend, wr0 + TS);
  const bool wlive = wr0 < rend;  // uniform over the warpgroup
  const int row_a = wr0 + (threadIdx.x / 32 % 4) * 16 + g;
  const float c2 = __fmul_rn(a.scale, LOG2E);
  const Band band = band_of(a);
  float nl[2], del[2];  // the thread's two rows' -lse * log2(e) and D
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    nl[r] = neg_lse2(row < rend ? a.lse[bh * a.lq + row] : 0.f, row < rend);
    del[r] = row < rend ? a.delta[bh * a.lq + row] : 0.f;
  }
  // the warpgroup's q and dO rows as the K-major A operand
  const uint64_t aq = tc::desc(q_s + wg * TS * 8, qc * 16, 128);
  const uint64_t ado = tc::desc(do_s + wg * TS * 8, qc * 16, 128);

  float dq[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) dq[j] = 0.f;

  RowUnit ld = row_settle<BAND>(a, RowUnit{start, -1, 0, 0, 0}, midp, stop,
                                r0, rend - 1);
  auto advance = [&]() {
    if (ld.p < stop) {
      ld.k0 += TS;
      ld = row_settle<BAND>(a, ld, midp, stop, r0, rend - 1);
    }
  };
  uint32_t parity = 0;  // bit st: the parity of stage st's next TMA phase
  for (int s = 0; s < RING - 1; ++s) {
    issue(ld, s);
    advance();
  }
  for (int n = 0;; ++n) {
    issue(ld, (n + RING - 1) % RING);
    advance();
    tc::cp_wait<RING - 1>();  // q, dO and unit n's cp.async copies landed
    __syncthreads();
    const bf16* ks =
        reinterpret_cast<const bf16*>(stages + (n % RING) * stage_bytes);
    const bf16* vs = ks + TS * D;
    const UnitMeta u = *reinterpret_cast<const UnitMeta*>(ks + 2 * TS * D);
    if (!u.ok) break;  // the same for every thread of the CTA
    if (u.tma) {
      mbar_wait(bars + n % RING, (parity >> (n % RING)) & 1);
      parity ^= 1u << (n % RING);
    }
    const int c = u.tile;
    const int k0 = u.lo;
    const int kend = u.hi;
    const bool live =
        wlive && !(BAND && !u.full &&
                   band_dead(a.causal, a.window, wr0 + a.offset,
                             wrend - 1 + a.offset, k0, kend - 1));
    if (live) {
      // S = q K^T and dP = dO V^T: K and V are the K-major B operand
      float s[32], dp[32];
      const uint64_t bk = tc::desc(ks, TS * 16, 128);
      const uint64_t bv = tc::desc(vs, TS * 16, 128);
      tc::wg_fence();
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        tc::wgmma_ss_n64(s, aq + kk * (2 * qc), bk + kk * (2 * TS), kk > 0);
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        tc::wgmma_ss_n64(dp, ado + kk * (2 * qc), bv + kk * (2 * TS), kk > 0);
      tc::wg_commit_wait();
      // P and dS in place; the entry e of a thread is row row_a + 8r,
      // key k0 + 8 (e >> 2) + 2tq + (e & 1)
      if (u.full && kend - k0 == TS) {
        // no mask and no key past the edge; rows past rend have P = 0
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int r = (e >> 1) & 1;
          p_ds(exp2f(fmaf(s[e], c2, nl[r])), del[r], s[e], dp[e]);
        }
      } else if (u.full) {
        // keys past kend drop out: K's zero rows would meet a P that may
        // overflow
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int r = (e >> 1) & 1;
          const int key = k0 + 8 * (e >> 2) + 2 * tq + (e & 1);
          p_ds(key < kend ? exp2f(fmaf(s[e], c2, nl[r])) : 0.f, del[r], s[e],
               dp[e]);
        }
      } else {
        const float* bias = bias_of<BAND>(a, i, u.p, false);
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int r = (e >> 1) & 1;
          const int row = row_a + 8 * r;
          const int key = k0 + 8 * (e >> 2) + 2 * tq + (e & 1);
          p_ds(p_masked<BAND>(a, band, bias, row - i * a.block_q,
                              key - c * a.block_k, row, key,
                              row < rend && key < kend,
                              fmaf(s[e], c2, nl[r])),
               del[r], s[e], dp[e]);
        }
      }
      // dQ += dS K: dS (bf16) is the register A operand, K the transposed
      // B operand (keys along K)
      uint32_t da[4][4];
      pack_a(dp, da);
      const uint64_t vk = tc::desc(ks, 128, TS * 16);
      tc::wg_fence();
#pragma unroll
      for (int m = 0; m < 4; ++m) tc::wgmma_pv<D>(dq, da[m], vk + m * 16);
      tc::wg_commit_wait();
    }
    __syncthreads();  // the stage is free for the unit that reuses it
  }
  tc::cp_wait<0>();  // the empty groups past the walk

  if (!wlive) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= rend) continue;
    bf16* out = a.dq + (bh * a.lq + row) * D + 2 * tq;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
          __floats2bfloat162_rn(__fmul_rn(dq[4 * j + 2 * r], a.scale),
                                __fmul_rn(dq[4 * j + 2 * r + 1], a.scale));
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

// f32, which = 0: dkdv over (nk * ceil(block_k / KS), Hkv, B); 1: dq over
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

// bf16, which = 0: dkdv, one CTA per (kc keys of a K tile, kv head, b);
// 1: dq, one CTA per (64 x dq_wgs rows of a Q tile, q head, b).  One
// dimension, heaviest tiles first (the kernels read blockIdx.x).
template <int D, bool BAND>
int launch_wgmma(const BwdArgs<bf16>& a, int batch, int which,
                 cudaStream_t s) {
  void (*kernel)(BwdArgs<bf16>, int, CUtensorMap, CUtensorMap);
  long long blocks;
  int wgs;
  size_t bytes;
  CUtensorMap map_a, map_b;  // q and dO (dK/dV), or K and V (dQ)
  const long long qrows = (long long)batch * a.hq * a.lq;
  const long long krows = (long long)batch * a.hkv * a.lk;
  if (qrows > INT_MAX || krows > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = which == 0 ? rows_map(&map_a, a.q, qrows, D)
                               : rows_map(&map_a, a.k, krows, D);
  if (err == cudaSuccess)
    err = which == 0 ? rows_map(&map_b, a.dout, qrows, D)
                     : rows_map(&map_b, a.v, krows, D);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (which == 0) {
    const int nk = (a.lk + a.block_k - 1) / a.block_k;
    const int kc = dkdv_keys(D, a.block_k);
    wgs = dkdv_wgs(D, a.block_k);
    blocks = (long long)nk * ((a.block_k + kc - 1) / kc) * batch * a.hkv;
    bytes = 2 * (size_t)kc * D * sizeof(bf16) + RING * dkdv_stage_bytes(D);
    kernel = fa_bwd_dkdv_wgmma_kernel<D, BAND>;
  } else {
    const int nq = (a.lq + a.block_q - 1) / a.block_q;
    wgs = dq_wgs(D, a.block_q);
    const int qc = TS * wgs;
    blocks = (long long)nq * ((a.block_q + qc - 1) / qc) * batch * a.hq;
    bytes = 2 * (size_t)qc * D * sizeof(bf16) + RING * dq_stage_bytes(D);
    kernel = fa_bwd_dq_wgmma_kernel<D, BAND>;
  }
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  err = fa::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), wgs * 128, bytes, s>>>(
      a, batch, map_a, map_b);
  return static_cast<int>(cudaGetLastError());
}

// bf16 runs the wgmma kernels, f32 the FMA ones
template <typename T, int D>
int launch_band(const BwdArgs<T>& a, int batch, bool band, int which,
                cudaStream_t s) {
  if constexpr (std::is_same_v<T, bf16>)
    return band ? launch_wgmma<D, true>(a, batch, which, s)
                : launch_wgmma<D, false>(a, batch, which, s);
  else
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
    case 112:
      return launch_band<T, 112>(a, batch, band, which, s);
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
    case 112:
      return launch_delta<T, 112>(o, dout, delta, rows, s);
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
                const void* colq, const void* colt, const void* order,
                const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* dq, void* dk,
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
                    static_cast<const int*>(order),
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
                const void* order, const void* q, const void* k,
                const void* v, const void* dout, const void* lse,
                const void* delta, void* dq, void* dk, void* dv, int batch,
                int hq, int hkv,
                int lq, int lk, int d, int block_q, int block_k, int band,
                int causal, int window, int offset, float scale, int dtype,
                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block_k < 1 || block_k > fa::BK_MAX || block_q < 1 || hkv < 1 ||
      hq % hkv || batch > 65535 || hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_dims<float>(
        args<float>(rowp, mid, prowp, cols, biases, colp, colq, colt, order,
                    q, k, v, dout, lse, delta, dq, dk, dv, hq, hkv, lq, lk,
                    block_q, block_k, causal, window, offset, scale),
        batch, d, band != 0, which, s);
  if (dtype == 1)
    return launch_dims<__nv_bfloat16>(
        args<__nv_bfloat16>(rowp, mid, prowp, cols, biases, colp, colq, colt,
                            order, q, k, v, dout, lse, delta, dq, dk, dv, hq,
                            hkv, lq, lk, block_q, block_k, causal, window,
                            offset, scale),
        batch, d, band != 0, which, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// o, dout (rows, d) contiguous in dtype (0 = f32, 1 = bf16); delta (rows,)
// f32.  d in {32, 64, 96, 112, 128, 256}.
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
// k); dq writes dq (like q).  The order arrays (int32) name the tiles
// heaviest first, for the bf16 kernels (f32 leaves them unused): corder
// (nk) the K tiles by descending column length, order (nq) the Q tiles by
// descending walk length (flash_attention_tiles_launch's).  The caller
// checks what flash_attention_tiles_launch's caller checks, and bf16 q, k,
// v and dout 16-byte aligned.
extern "C" int fa_bwd_dkdv_launch(
    const void* rowp, const void* mid, const void* prowp, const void* cols,
    const void* biases, const void* colp, const void* colq, const void* colt,
    const void* corder, const void* q, const void* k, const void* v,
    const void* dout, const void* lse, const void* delta, void* dk, void* dv,
    int batch, int hq, int hkv, int lq, int lk, int d, int block_q,
    int block_k, int band, int causal, int window, int offset, float scale,
    int dtype, void* stream) {
  return grad_launch(0, rowp, mid, prowp, cols, biases, colp, colq, colt,
                     corder, q, k, v, dout, lse, delta, nullptr, dk, dv,
                     batch, hq, hkv, lq, lk, d, block_q, block_k, band,
                     causal, window, offset, scale, dtype, stream);
}

extern "C" int fa_bwd_dq_launch(
    const void* rowp, const void* mid, const void* prowp, const void* cols,
    const void* biases, const void* order, const void* q, const void* k,
    const void* v, const void* dout, const void* lse, const void* delta,
    void* dq, int batch, int hq, int hkv, int lq, int lk, int d, int block_q,
    int block_k, int band, int causal, int window, int offset, float scale,
    int dtype, void* stream) {
  return grad_launch(1, rowp, mid, prowp, cols, biases, nullptr, nullptr,
                     nullptr, order, q, k, v, dout, lse, delta, dq, nullptr,
                     nullptr, batch, hq, hkv, lq, lk, d, block_q, block_k,
                     band, causal, window, offset, scale, dtype, stream);
}
