// Key-length flash attention with GQA, split over the keys, in CUDA for
// sm_90a: f32 or bf16 q, k, v; f32 softmax state.  Replaces the Pallas TPU
// kernels src/repro/kernels/flash_attention.py:183
// (flash_attention_lens_kernel) and :201 (flash_attention_lens_state_kernel):
// online-softmax attention of q-head h over the keys kpos < kv_len[b] of
// kv-head h / (Hq / Hkv), optionally causal (qpos >= kpos, no offset), with
// or without the final state (m, l).  It is the read path of paged decode
// (Lq = 1 against a slot's gathered pages) and the prefix half of chunked
// prefill (a chunk's Lq rows against the gathered prefix).
//
// Bound on this card: bytes.  At paged decode (B = 8 slots, Hq/Hkv 16/8,
// d = 128, kv_len 1 .. 2048) the live keys and values are 33.6 MB and the
// products 0.13 GFLOP, so 3.35 TB/s bounds it near 10 us; only parallelism
// over the keys reaches that.  The Pallas grid walks a (b, h)'s keys in
// order with the state in VMEM; a CTA that did so here (one per (b, h),
// Lq = 1 of its 16 rows live) walked 2048 keys serially on 128 CTAs.
//
// Design.  Rows: the q-heads of one kv-head are contiguous in q, so the
// group x Lq rows of (b, kv-head) form one row-major block (row r is
// q-head h0 + r / Lq at position r % Lq), and a CTA owns a row block of
// them: every K/V byte is read once per row block, not once per q-head.
// Keys: the K tiles of the capacity Lk (block_k keys each, the last may be
// short) are cut into nsplit ranges of tps whole tiles
// (kernels/flash_attention.py lens_partition, from Lk and the SM count: the
// live lengths stay on the card).  CTA (split s, row block, b, kv-head)
// folds the tiles of range s below the keys its rows may see (kv_len[b],
// and the causal limit of its last row) into an (acc, m, l) partial; within
// a range the tile folds are fa::fold_tile's recurrence (one max and one
// rescale per block_k tile, p rounded to V's type for P V, expf and
// explicit round-to-nearest ops).  Every CTA of a group computes how many
// of its ranges hold such a tile (nlive; they are ranges 0 .. nlive - 1):
// a range wholly past those keys exits at once and takes no part; the
// only live range writes o (and m, l) itself; with several, each writes
// its partial to an f32 scratch and the last of them to arrive (an integer
// ticket, reset by that CTA) merges the partials in range order in the
// same launch: M = max m_s, c_s = exp(m_s - M), l = sum c_s l_s, o = sum
// c_s acc_s / l, merge_states' algebra; a row with m_s = NEG_INF in a
// range weighs 0 there.  No float atomics: the result is bitwise the same
// from run to run.
//
// Two regimes, each its own kernel:
//
//   flash_attention_lens_decode_kernel  (f32 and bf16, up to 16 rows a
//       CTA; every f32 call, and bf16 with at most 16 rows per group):
//       bytes-bound.  128 threads stream the range's K and V in chunks of
//       up to 128 keys by 16-byte cp.async into a two-buffer ring (rows
//       padded by 16 bytes, so 16-byte reads are conflict-free), chunk
//       i + 1 in flight while chunk i is used.  Scores: a key per 1, 2 or
//       4 threads, q in shared memory as f32, an FMA chain over d; the
//       tile's max and sum are a warp butterfly then the 4 warps in order;
//       P V: a thread owns 8 columns and every (128 / 8d-chunks)-th key,
//       with the rows' accumulators in registers, summed over the key
//       groups in a fixed order at the end.  All in f32 on the FMA units.
//   flash_attention_lens_prefix_kernel  (bf16 with more than 16 rows a
//       group, such as a 128-token chunk's prefix): up to 128 rows a CTA
//       folded on the tensor cores by tc::fold_rows
//       (flash_attention_wgmma.cuh) over a LensWalk (tiles t0 .. t0 + n - 1
//       of the range, masked by key < kv_len[b] and the causal compare),
//       writing an f32 partial (FoldOut) when the keys are split.
//
// Both are compiled at head_dim 32, 64, 96, 128 and 256.
#include <algorithm>
#include <type_traits>

#include "flash_attention_wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using fa::NEG_INF;

constexpr int DEC_THREADS = 128;
constexpr int DEC_WARPS = DEC_THREADS / 32;
constexpr int MAX_SPLITS = 64;

template <typename T>
struct LensArgs {
  const T* q;
  const T* k;
  const T* v;
  const int* lens;  // (B,)
  T* o;
  float* m;  // (B, Hq, Lq) or null
  float* l;
  float* part;   // (groups, nsplit, rows_blk x (D + 2)) f32; null: 1 split
  int* tickets;  // (groups,), 0 between launches
  int hq, hkv, lq, lk, block_k;
  float scale;
  int causal;
  int rows_blk;  // rows of a row block (a CTA's rows)
  int nrb;       // row blocks per (b, kv-head)
  int nsplit;    // key ranges
  int tps;       // K tiles per range
};

// What one CTA works on.
struct Block {
  int b, hk, s;
  int g;           // its (b, kv-head, row block): the ticket and partials
  int q0, nr;      // its rows [q0, q0 + nr) of the group's rows
  int kv_len;      // live keys of b
  int kend;        // keys any of its rows may see
  int t0, n;       // first K tile of its range, tiles below kend in it
  int nlive;       // ranges of the group with a tile below kend (0 .. nlive)
  size_t qo;       // element offset / d of the group's row 0 in q and o
  size_t kvo;      // element offset / d of (b, kv-head) in k and v
};

template <typename T>
__device__ __forceinline__ Block block_of(const LensArgs<T>& a) {
  Block k;
  k.s = blockIdx.x;
  const int rb = blockIdx.y % a.nrb;
  k.hk = blockIdx.y / a.nrb;
  k.b = blockIdx.z;
  k.g = (k.b * a.hkv + k.hk) * a.nrb + rb;
  const int group = a.hq / a.hkv;
  k.q0 = rb * a.rows_blk;
  k.nr = min(a.rows_blk, group * a.lq - k.q0);
  k.kv_len = min(max(a.lens[k.b], 0), a.lk);
  k.kend = k.kv_len;
  if (a.causal) {
    // row r is at position r % lq; the largest among the CTA's rows
    const int last = k.q0 + k.nr - 1;
    const int qmax = k.q0 / a.lq != last / a.lq ? a.lq - 1 : last % a.lq;
    k.kend = min(k.kend, qmax + 1);
  }
  const int ntiles = (a.lk + a.block_k - 1) / a.block_k;
  const int live = min(ntiles, (k.kend + a.block_k - 1) / a.block_k);
  k.t0 = k.s * a.tps;
  k.n = max(0, min(k.t0 + a.tps, live) - k.t0);
  k.nlive = (live + a.tps - 1) / a.tps;
  k.qo = ((size_t)k.b * a.hq + (size_t)k.hk * group) * a.lq;
  k.kvo = ((size_t)k.b * a.hkv + k.hk) * a.lk;
  return k;
}

// What a CTA does with its range: nothing (a range past the keys its rows
// may see, unless no range of the group has a live tile: then range 0
// writes the empty result), write o itself (the group's only live range),
// or write a partial for the group's last CTA to merge.
enum class Role { kNone, kDirect, kPartial };
__device__ __forceinline__ Role role_of(const Block& k) {
  if (k.n == 0)
    return k.s == 0 && k.nlive == 0 ? Role::kDirect : Role::kNone;
  return k.nlive == 1 ? Role::kDirect : Role::kPartial;
}

// Split s's partial of group g: acc (rows_blk x D), then m and l
// (rows_blk each).
template <typename T, int D>
__device__ __forceinline__ float* partial(const LensArgs<T>& a, int g,
                                          int s) {
  return a.part + ((size_t)g * a.nsplit + s) * a.rows_blk * (D + 2);
}

// Shared memory the merge needs, in floats: each range's m (then its
// weight) and l per row, then M and l per row.
__host__ __device__ constexpr size_t merge_floats(int nsplit, int rows) {
  return (size_t)(2 * nsplit + 2) * rows;
}

// Called by every thread of a kPartial CTA once its partial is in global
// memory: the last of the group's k.nlive live ranges to arrive merges
// their partials in range order and writes o (and m, l), then resets the
// ticket.  `scratch` is shared memory of merge_floats(nsplit, rows_blk)
// floats.  The partials lie in L2; every phase keeps many independent
// loads in flight: all (range, row) states at once, then 4 columns x 4
// elements x 4 ranges a thread per round.
template <typename T, int D>
__device__ __forceinline__ void finish_split(const LensArgs<T>& a,
                                             const Block& k,
                                             float* scratch) {
  __shared__ int ticket;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) ticket = atomicAdd(a.tickets + k.g, 1);
  __syncthreads();
  if (ticket != k.nlive - 1) return;
  __threadfence();

  const int ns = k.nlive;
  const int rb = a.rows_blk;
  const float* p0 = partial<T, D>(a, k.g, 0);
  const size_t rec = (size_t)rb * (D + 2);  // a multiple of 4 floats
  float* w_s = scratch;       // (ns, rb): m of range s, then its weight
  float* l_s = w_s + ns * rb;  // (ns, rb)
  float* mm = l_s + ns * rb;   // M per row
  float* ll = mm + rb;         // l per row
#pragma unroll 4
  for (int e = threadIdx.x; e < ns * k.nr; e += blockDim.x) {
    const int s = e / k.nr;
    const int r = e - s * k.nr;
    const float* p = p0 + s * rec + rb * D;
    w_s[s * rb + r] = __ldcg(p + r);
    l_s[s * rb + r] = __ldcg(p + rb + r);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < k.nr; r += blockDim.x) {
    float m = NEG_INF;
    for (int s = 0; s < ns; ++s) m = fmaxf(m, w_s[s * rb + r]);
    float l = 0.f;
    for (int s = 0; s < ns; ++s) {
      // a range with no live key for this row weighs 0 (its acc and l
      // were never written)
      const float ms = w_s[s * rb + r];
      const float c = ms == NEG_INF ? 0.f : expf(__fsub_rn(ms, m));
      if (c != 0.f) l = __fadd_rn(l, __fmul_rn(c, l_s[s * rb + r]));
      w_s[s * rb + r] = c;
    }
    mm[r] = m;
    ll[r] = l;
  }
  __syncthreads();
  // o = sum_s c_s acc_s / l, 4 columns at a time, ranges in order
  constexpr int EPT = 4, SU = 4;
  const int n4 = k.nr * D / 4;
  T* o = a.o + (k.qo + k.q0) * D;
  for (int base = threadIdx.x; base < n4; base += EPT * blockDim.x) {
    float4 acc[EPT];
#pragma unroll
    for (int j = 0; j < EPT; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < ns; s0 += SU) {
      float4 x[SU][EPT];
#pragma unroll
      for (int u = 0; u < SU; ++u)
#pragma unroll
        for (int j = 0; j < EPT; ++j) {
          const int e4 = base + j * blockDim.x;
          const int s = s0 + u;
          x[u][j] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (s < ns && e4 < n4 && w_s[s * rb + e4 / (D / 4)] != 0.f)
            x[u][j] = __ldcg(reinterpret_cast<const float4*>(
                p0 + s * rec + 4 * (size_t)e4));
        }
#pragma unroll
      for (int u = 0; u < SU; ++u)
#pragma unroll
        for (int j = 0; j < EPT; ++j) {
          const int e4 = base + j * blockDim.x;
          if (s0 + u >= ns || e4 >= n4) continue;
          const float c = w_s[(s0 + u) * rb + e4 / (D / 4)];
          if (c == 0.f) continue;
          acc[j].x = __fadd_rn(acc[j].x, __fmul_rn(c, x[u][j].x));
          acc[j].y = __fadd_rn(acc[j].y, __fmul_rn(c, x[u][j].y));
          acc[j].z = __fadd_rn(acc[j].z, __fmul_rn(c, x[u][j].z));
          acc[j].w = __fadd_rn(acc[j].w, __fmul_rn(c, x[u][j].w));
        }
    }
#pragma unroll
    for (int j = 0; j < EPT; ++j) {
      const int e4 = base + j * blockDim.x;
      if (e4 >= n4) continue;
      const int r = e4 / (D / 4);
      const float den = fmaxf(ll[r], 1e-30f);
      T* dst = o + 4 * (size_t)e4;
      dst[0] = fa::from_f<T>(__fdiv_rn(acc[j].x, den));
      dst[1] = fa::from_f<T>(__fdiv_rn(acc[j].y, den));
      dst[2] = fa::from_f<T>(__fdiv_rn(acc[j].z, den));
      dst[3] = fa::from_f<T>(__fdiv_rn(acc[j].w, den));
      if (e4 % (D / 4) == 0 && a.m != nullptr) {
        a.m[k.qo + k.q0 + r] = mm[r];
        a.l[k.qo + k.q0 + r] = ll[r];
      }
    }
  }
  if (threadIdx.x == 0) a.tickets[k.g] = 0;  // for the next launch
}

// ---------------------------------------------------------------------------
// the decode regime: the FMA units, up to RMAX rows a CTA
// ---------------------------------------------------------------------------

template <typename T, int D>
struct Decode {
  // a staged key row: D elements plus 16 bytes, so that 16-byte reads of
  // 8 neighbouring rows (a quarter warp) hit distinct banks (STRIDE / 16 is
  // odd for every D here)
  static constexpr int STRIDE = D * (int)sizeof(T) + 16;
  // keys per staged chunk: a ring buffer holds at most 128 x 272 bytes
  static constexpr int TK = STRIDE <= 272 ? 128 : STRIDE <= 544 ? 64 : 32;
  static constexpr int SPLITD = DEC_THREADS / TK;  // threads per key (S)
  static constexpr int PIECES = D * (int)sizeof(T) / 16;  // 16 B a row
  static constexpr int CH = D / 8;                 // 8-column chunks (P V)
  static constexpr int CHP = CH <= 4 ? 4 : CH <= 8 ? 8 : CH <= 16 ? 16 : 32;
  static constexpr int KG = DEC_THREADS / CHP;     // key groups (P V)
  static constexpr int RING = 2 * TK * STRIDE;
  static_assert(D / 8 % SPLITD == 0, "groups of 8 per thread");
  static_assert(CHP <= 32, "column chunks");
};

template <typename T, int D, int RMAX>
constexpr size_t decode_smem() {
  // q (f32), scores, the state (m, l, alpha), the warps' reductions, ring
  return sizeof(float) * (RMAX * D + RMAX * fa::BK_MAX + 3 * RMAX +
                          DEC_WARPS * RMAX) +
         Decode<T, D>::RING;
}

// 8 values of a staged row at p, as f32
template <typename T>
__device__ __forceinline__ void load8(const unsigned char* p, float (&x)[8]);
template <>
__device__ __forceinline__ void load8<bf16>(const unsigned char* p,
                                            float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
template <>
__device__ __forceinline__ void load8<float>(const unsigned char* p,
                                             float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 16);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

template <typename T, int D, int RMAX>
__global__ void __launch_bounds__(DEC_THREADS)
    flash_attention_lens_decode_kernel(LensArgs<T> a) {
  using S = Decode<T, D>;
  constexpr int BK = fa::BK_MAX;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // RMAX x D
  float* s_s = q_s + RMAX * D;                  // RMAX x BK: scores, then p
  float* st_m = s_s + RMAX * BK;
  float* st_l = st_m + RMAX;
  float* st_alpha = st_l + RMAX;
  float* red = st_alpha + RMAX;                 // DEC_WARPS x RMAX
  unsigned char* ring =
      reinterpret_cast<unsigned char*>(red + DEC_WARPS * RMAX);

  const Block k = block_of(a);
  const Role role = role_of(k);
  if (role == Role::kNone) return;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;

  // The chunk stream: tile t of the range (K tile k.t0 + t) gives its K
  // chunks, then its V chunks, of up to TK keys each; only the last tile
  // may hold fewer than block_k keys (the capacity's end or kend).
  const int bk = a.block_k;
  const int keys_last = min(bk, k.kend - (k.t0 + k.n - 1) * bk);
  const int ncf = (bk + S::TK - 1) / S::TK;
  const int ncl = (keys_last + S::TK - 1) / S::TK;
  const int total = k.n > 0 ? (k.n - 1) * 2 * ncf + 2 * ncl : 0;
  auto locate = [&](int i, int& t, bool& val, int& c, int& keys) {
    t = i / (2 * ncf);
    int nc = ncf;
    if (t >= k.n - 1) {
      t = k.n - 1;
      nc = ncl;
    }
    const int rest = i - t * 2 * ncf;
    val = rest >= nc;
    c = val ? rest - nc : rest;
    keys = t == k.n - 1 ? keys_last : bk;
  };
  auto issue = [&](int i) {
    if (i < total) {
      int t, c, keys;
      bool val;
      locate(i, t, val, c, keys);
      const int rows = min(S::TK, keys - c * S::TK);
      const unsigned char* src = reinterpret_cast<const unsigned char*>(
          (val ? a.v : a.k) +
          (k.kvo + (size_t)(k.t0 + t) * bk + c * S::TK) * D);
      unsigned char* dst = ring + (i & 1) * S::TK * S::STRIDE;
      for (int e = tid; e < rows * S::PIECES; e += DEC_THREADS) {
        const int row = e / S::PIECES;
        const int pc = e - row * S::PIECES;
        tc::cp_async16(dst + row * S::STRIDE + pc * 16,
                       src + (size_t)row * D * sizeof(T) + pc * 16, true);
      }
    }
    tc::cp_commit();
  };

  // the first chunk's copy goes out before q is staged
  issue(0);
  for (int e = tid; e < RMAX * D; e += DEC_THREADS) {
    const int r = e / D;
    q_s[e] = r < k.nr ? fa::to_f(a.q[(k.qo + k.q0) * D + e]) : 0.f;
  }
  if (tid < RMAX) {
    st_m[tid] = NEG_INF;
    st_l[tid] = 0.f;
    st_alpha[tid] = 1.f;
  }

  float acc[RMAX][8];
#pragma unroll
  for (int r = 0; r < RMAX; ++r)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;

  for (int i = 0; i < total; ++i) {
    issue(i + 1);
    tc::cp_wait<1>();  // chunk i has landed
    __syncthreads();
    int t, c, keys;
    bool val;
    locate(i, t, val, c, keys);
    const int rows_c = min(S::TK, keys - c * S::TK);
    const unsigned char* buf = ring + (i & 1) * S::TK * S::STRIDE;
    if (!val) {
      // scores of the chunk's keys: key kk of the chunk on SPLITD
      // neighbouring lanes, each over NG groups of 8 of d
      constexpr int NG = D / 8 / S::SPLITD;
      const int kk = tid / S::SPLITD;
      const int part = tid % S::SPLITD;
      float dot[RMAX];
#pragma unroll
      for (int r = 0; r < RMAX; ++r) dot[r] = 0.f;
      if (kk < rows_c) {
        const unsigned char* row =
            buf + kk * S::STRIDE + part * NG * 8 * sizeof(T);
#pragma unroll 2
        for (int gi = 0; gi < NG; ++gi) {
          float kv[8];
          load8<T>(row + gi * 8 * sizeof(T), kv);
          const int d0 = (part * NG + gi) * 8;
#pragma unroll
          for (int r = 0; r < RMAX; ++r) {
            if (r >= k.nr) break;
            const float4 qa =
                *reinterpret_cast<const float4*>(q_s + r * D + d0);
            const float4 qb =
                *reinterpret_cast<const float4*>(q_s + r * D + d0 + 4);
            const float qv[8] = {qa.x, qa.y, qa.z, qa.w,
                                 qb.x, qb.y, qb.z, qb.w};
#pragma unroll
            for (int e = 0; e < 8; ++e) dot[r] = fmaf(qv[e], kv[e], dot[r]);
          }
        }
      }
#pragma unroll
      for (int off = 1; off < S::SPLITD; off <<= 1)
#pragma unroll
        for (int r = 0; r < RMAX; ++r)
          dot[r] = __fadd_rn(dot[r],
                             __shfl_xor_sync(0xffffffffu, dot[r], off));
      if (part == 0 && kk < rows_c) {
        // every staged key lies below kend <= kv_len; the causal compare
        // is per row
        const int kt = c * S::TK + kk;
        const int kpos = (k.t0 + t) * bk + kt;
#pragma unroll
        for (int r = 0; r < RMAX; ++r) {
          if (r >= k.nr) break;
          const bool live = !a.causal || (k.q0 + r) % a.lq >= kpos;
          s_s[r * BK + kt] = live ? __fmul_rn(dot[r], a.scale) : NEG_INF;
        }
      }
      if (c == (t == k.n - 1 ? ncl : ncf) - 1) {
        // the tile's scores are complete: its online-softmax step
        __syncthreads();
        const float kDrop = __int_as_float(0xff800000);  // -inf
#pragma unroll
        for (int r = 0; r < RMAX; ++r) {
          if (r >= k.nr) break;
          float x = tid < keys ? s_s[r * BK + tid] : kDrop;
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
          if (lane == 0) red[warp * RMAX + r] = x;
        }
        __syncthreads();
        if (tid < k.nr) {
          float mx = red[tid];
#pragma unroll
          for (int w = 1; w < DEC_WARPS; ++w)
            mx = fmaxf(mx, red[w * RMAX + tid]);
          const float m_prev = st_m[tid];
          const float m_cur = fmaxf(m_prev, mx);
          st_alpha[tid] = expf(__fsub_rn(m_prev, m_cur));
          st_m[tid] = m_cur;
        }
        __syncthreads();
#pragma unroll
        for (int r = 0; r < RMAX; ++r) {
          if (r >= k.nr) break;
          float ps = 0.f;
          if (tid < keys) {
            const float p = expf(__fsub_rn(s_s[r * BK + tid], st_m[r]));
            s_s[r * BK + tid] = fa::round_to<T>(p);
            ps = p;
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            ps = __fadd_rn(ps, __shfl_xor_sync(0xffffffffu, ps, off));
          if (lane == 0) red[warp * RMAX + r] = ps;
        }
        __syncthreads();
        if (tid < k.nr) {
          float ps = red[tid];
#pragma unroll
          for (int w = 1; w < DEC_WARPS; ++w)
            ps = __fadd_rn(ps, red[w * RMAX + tid]);
          st_l[tid] = __fadd_rn(__fmul_rn(st_l[tid], st_alpha[tid]), ps);
        }
      }
    } else {
      // P V: column chunk cc (8 columns) over keys kg, kg + KG, ...
      const int cc = tid % S::CHP;
      const int kg = tid / S::CHP;
      if (c == 0) {
#pragma unroll
        for (int r = 0; r < RMAX; ++r) {
          const float al = st_alpha[r];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[r][e] = __fmul_rn(acc[r][e], al);
        }
      }
      if (cc < S::CH) {
        const float* pc = s_s + c * S::TK;
        for (int j = kg; j < rows_c; j += S::KG) {
          float vv[8];
          load8<T>(buf + j * S::STRIDE + cc * 8 * sizeof(T), vv);
#pragma unroll
          for (int r = 0; r < RMAX; ++r) {
            if (r >= k.nr) break;
            const float p = pc[r * BK + j];
#pragma unroll
            for (int e = 0; e < 8; ++e)
              acc[r][e] = fmaf(p, vv[e], acc[r][e]);
          }
        }
      }
    }
    __syncthreads();  // buffer i & 1 is free for chunk i + 2
  }

  // the key groups' sums: lanes of one column chunk in a warp (a
  // butterfly), then the warps in order, through the free ring
#pragma unroll
  for (int off = S::CHP; off < 32; off <<= 1)
#pragma unroll
    for (int r = 0; r < RMAX; ++r)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[r][e] = __fadd_rn(acc[r][e],
                              __shfl_xor_sync(0xffffffffu, acc[r][e], off));
  float* sums = reinterpret_cast<float*>(ring);  // DEC_WARPS x RMAX x D
  static_assert(sizeof(float) * DEC_WARPS * RMAX * D <= (size_t)S::RING &&
                    sizeof(float) * merge_floats(MAX_SPLITS, RMAX) <=
                        (size_t)S::RING,
                "the warps' sums and the merge's scratch fit the ring");
  if (lane < S::CH) {
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      if (r >= k.nr) break;
      float* dst = sums + (warp * RMAX + r) * D + lane * 8;
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
    }
  }
  __syncthreads();
  float* rec =
      role == Role::kPartial ? partial<T, D>(a, k.g, k.s) : nullptr;
  T* o = a.o + (k.qo + k.q0) * D;
  for (int e = tid; e < k.nr * D; e += DEC_THREADS) {
    const int r = e / D;
    const int col = e - r * D;
    float x = sums[r * D + col];
#pragma unroll
    for (int w = 1; w < DEC_WARPS; ++w)
      x = __fadd_rn(x, sums[(w * RMAX + r) * D + col]);
    if (rec != nullptr) {
      rec[e] = x;
      if (col == 0) {
        rec[a.rows_blk * D + r] = st_m[r];
        rec[a.rows_blk * D + a.rows_blk + r] = st_l[r];
      }
    } else {
      o[e] = fa::from_f<T>(__fdiv_rn(x, fmaxf(st_l[r], 1e-30f)));
      if (col == 0 && a.m != nullptr) {
        a.m[k.qo + k.q0 + r] = st_m[r];
        a.l[k.qo + k.q0 + r] = st_l[r];
      }
    }
  }
  // the ring is the merge's scratch (finish_split syncs before using it)
  if (rec != nullptr)
    finish_split<T, D>(a, k, reinterpret_cast<float*>(ring));
}

// ---------------------------------------------------------------------------
// the prefix regime: bf16 on the tensor cores through tc::fold_rows
// ---------------------------------------------------------------------------

// Tiles t0 .. t0 + n - 1; every tile masked by key < kv_len and, when
// causal, the compare of the row's position (row % lq) with the key's.
struct LensWalk {
  int t0, n, block_k, kv_len, lq;
  bool causal;
  __device__ __forceinline__ int ntile() const { return n; }
  __device__ __forceinline__ int col(int t) const { return t0 + t; }
  __device__ __forceinline__ bool masked(int) const { return true; }
  __device__ __forceinline__ float mask(int, int c, int row, int key,
                                        float x) const {
    const int kpos = c * block_k + key;
    const bool live = kpos < kv_len && (!causal || row % lq >= kpos);
    return live ? x : NEG_INF;
  }
};

template <int D, bool STATE>
__global__ void __launch_bounds__(tc::THREADS_MAX, 1)
    flash_attention_lens_prefix_kernel(LensArgs<bf16> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Block k = block_of(a);
  const Role role = role_of(k);
  if (role == Role::kNone) return;
  const LensWalk walk{k.t0, k.n, a.block_k, k.kv_len, a.lq, a.causal != 0};
  tc::FoldOut dst{a.o + k.qo * D, STATE ? a.m + k.qo : nullptr,
                  STATE ? a.l + k.qo : nullptr};
  if (role == Role::kPartial) {
    dst.acc = partial<bf16, D>(a, k.g, k.s);
    dst.acc_m = dst.acc + a.rows_blk * D;
    dst.acc_l = dst.acc_m + a.rows_blk;
  }
  tc::fold_rows<D, STATE>(a.q + k.qo * D, a.k + k.kvo * D, a.v + k.kvo * D,
                          dst, k.q0, k.q0 + k.nr, a.lk, a.block_k, a.scale,
                          walk);
  if (role == Role::kPartial)
    finish_split<bf16, D>(a, k, reinterpret_cast<float*>(smem));
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, int D>
int launch_d(const LensArgs<T>& a, int batch, bool prefix, bool state,
             cudaStream_t s) {
  const dim3 grid(a.nsplit, a.nrb * a.hkv, batch);
  const size_t merge = sizeof(float) * merge_floats(a.nsplit, a.rows_blk);
  cudaError_t err = cudaErrorInvalidValue;
  if (!prefix) {
    if (a.rows_blk == 4) {
      auto kernel = flash_attention_lens_decode_kernel<T, D, 4>;
      const size_t bytes = decode_smem<T, D, 4>();
      err = fa::allow_smem(kernel, bytes);
      if (err == cudaSuccess) kernel<<<grid, DEC_THREADS, bytes, s>>>(a);
    } else if (a.rows_blk == 16) {
      auto kernel = flash_attention_lens_decode_kernel<T, D, 16>;
      const size_t bytes = decode_smem<T, D, 16>();
      err = fa::allow_smem(kernel, bytes);
      if (err == cudaSuccess) kernel<<<grid, DEC_THREADS, bytes, s>>>(a);
    }
  } else if constexpr (std::is_same_v<T, bf16>) {
    if (a.rows_blk == 64 || a.rows_blk == 128) {
      auto kernel = state ? flash_attention_lens_prefix_kernel<D, true>
                          : flash_attention_lens_prefix_kernel<D, false>;
      const size_t bytes =
          std::max(tc::smem_bytes<D>(a.rows_blk, a.block_k), merge);
      err = fa::allow_smem(kernel, bytes);
      if (err == cudaSuccess)
        kernel<<<grid, 2 * a.rows_blk, bytes, s>>>(a);
    }
  }
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename T>
int launch_dtype(const LensArgs<T>& a, int batch, int d, bool prefix,
                 bool state, cudaStream_t s) {
  switch (d) {
    case 32:
      return launch_d<T, 32>(a, batch, prefix, state, s);
    case 64:
      return launch_d<T, 64>(a, batch, prefix, state, s);
    case 96:
      return launch_d<T, 96>(a, batch, prefix, state, s);
    case 128:
      return launch_d<T, 128>(a, batch, prefix, state, s);
    case 256:
      return launch_d<T, 256>(a, batch, prefix, state, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, Hq, Lq, d), k / v (B, Hkv, Lk, d), all 16-byte aligned; lens (B,)
// int32; o like q; m, l (B, Hq, Lq) f32 when state.  dtype 0 = f32, 1 =
// bf16; prefix = 1 runs the tensor-core kernel (bf16 only, rows_blk 64 or
// 128), else the decode kernel (rows_blk 4 or 16).  nsplit ranges of tps K
// tiles (kernels/flash_attention.py lens_partition); with nsplit > 1, part
// is an f32 scratch of groups x nsplit x rows_blk x (d + 2) floats and
// tickets groups int32 zeros (groups = B x Hkv x row blocks), left at 0.
// The caller checks Hq % Hkv == 0, block_k <= 128, d in {32, 64, 96, 128,
// 256}.
extern "C" int flash_attention_lens_launch(
    const void* q, const void* k, const void* v, const void* lens, void* o,
    void* m, void* l, void* part, void* tickets, int batch, int hq, int hkv,
    int lq, int lk, int d, int block_k, float scale, int causal, int state,
    int dtype, int prefix, int rows_blk, int nsplit, int tps,
    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block_k < 1 || block_k > fa::BK_MAX || hkv < 1 || hq % hkv ||
      rows_blk < 1 || nsplit < 1 || nsplit > MAX_SPLITS || tps < 1 ||
      (long long)nsplit * tps * block_k < lk || batch > 65535 ||
      (nsplit > 1 && (part == nullptr || tickets == nullptr)) ||
      (prefix && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = hq / hkv * lq;
  const int nrb = (rows + rows_blk - 1) / rows_blk;
  if ((long long)nrb * hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    const LensArgs<float> a{
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const int*>(lens),
        static_cast<float*>(o), static_cast<float*>(m),
        static_cast<float*>(l), static_cast<float*>(part),
        static_cast<int*>(tickets), hq, hkv, lq, lk, block_k, scale, causal,
        rows_blk, nrb, nsplit, tps};
    return launch_dtype<float>(a, batch, d, prefix != 0, state != 0, s);
  }
  if (dtype == 1) {
    const LensArgs<bf16> a{
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const int*>(lens),
        static_cast<bf16*>(o), static_cast<float*>(m),
        static_cast<float*>(l), static_cast<float*>(part),
        static_cast<int*>(tickets), hq, hkv, lq, lk, block_k, scale, causal,
        rows_blk, nrb, nsplit, tps};
    return launch_dtype<bf16>(a, batch, d, prefix != 0, state != 0, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
