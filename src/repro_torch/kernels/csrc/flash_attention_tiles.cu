// Tile-skipping flash attention over a compiled TileLayout, in CUDA for
// sm_90a: f32 or bf16 q, k, v; f32 softmax state.
//
//   flash_attention_tiles_kernel       (f32) and
//   flash_attention_tiles_bf16_kernel  (bf16) replace the Pallas TPU
//                                 kernels src/repro/kernels/flash_attention.py
//                                 :275 (flash_attention_tiles_kernel) and
//                                 :290 (flash_attention_tiles_state_kernel),
//                                 with the walk _fa_tiles_scan (:219)
//
// The layout (src/repro_torch/sparse/maskcompiler.py) lists, for each Q tile
// i of block_q rows, its live K tiles: cols[rowp[i] : mid[i]] are FULL (no
// mask), cols[mid[i] : rowp[i+1]] are PARTIAL.  A PARTIAL tile is masked by
// the band (causal, window, offset) as an iota compare (template BAND), or
// else by adding its stored bias tile biases[prowp[i] + (p - mid[i])].  The
// Pallas grid is (b, h, Q tile) with the walk inside; here a CTA owns rows
// of one Q tile of one (b, h) and walks the tile's list.  The last Q tile
// and the last K tile are short when the blocks do not divide the lengths;
// a short K tile is folded with its own key count.  Rows whose Q tile has
// no live K tile output 0 with m = NEG_INF and l = 0, and so does a row
// whose entries are all masked in the tiles it walks (m = NEG_INF, l > 0):
// its backward gives it no probability.  The kernel is chosen
// by dtype: f32 keeps the FMA fold, bf16 runs on the tensor cores.
//
// f32.  One CTA owns fa::ROWS rows (a Q tile of block_q rows is cut into
// ceil(block_q / ROWS) CTAs).  Every tile is folded by fa::fold_tile, as in
// flash_attention.cu, and the causal layout lists a Q tile's K tiles in
// ascending order, as the dense grid visits them; so over causal_layout
// this kernel is bitwise equal to flash_attention_kernel with causal = true
// in f32.  Tensor cores would run f32 as TF32 and lose that.
//
// bf16.  One CTA owns up to 128 rows of a Q tile (one warpgroup per 64
// rows) and folds the tile's walk through tc::fold_rows
// (flash_attention_wgmma.cuh), the tensor-core fold it shares with the
// dense grid's bf16 kernel; the walk is cols[rowp[i] .. rowp[i+1]), and
// the band or bias mask applies to its PARTIAL tiles.  Over causal_layout
// it is therefore bitwise equal to flash_attention_bf16_kernel with
// causal = true, as the f32 kernels are.  The CTAs of the Q tiles with the
// longest walks start first (``order``, from the wrapper).  The layout's
// index arrays stay on the card (the wrapper caches them per layout and
// device).
#include <limits.h>

#include <algorithm>
#include <type_traits>

#include "flash_attention_wgmma.cuh"

namespace {

using fa::ROWS;

template <typename T>
struct TilesArgs {
  const int* rowp;
  const int* mid;
  const int* prowp;
  const int* cols;
  const float* biases;  // (npart, block_q, block_k)
  const T* q;
  const T* k;
  const T* v;
  T* o;
  float* m;  // (B, Hq, Lq) or null
  float* l;
  int hq, hkv, lq, lk, block_q, block_k;
  int causal, window, offset;  // the band; window < 0 means none
  float scale;
};

struct BandMask {
  int qband0;  // q position + offset of the warp's row 0
  int k0;
  bool causal;
  int window;
  __device__ __forceinline__ float operator()(int r, int j, float s) const {
    const int qb = qband0 + r;
    const int kpos = k0 + j;
    bool live = true;
    if (causal) live = qb >= kpos;
    if (window >= 0)
      live = live && (causal ? qb - kpos < window : abs(qb - kpos) < window);
    return live ? s : fa::NEG_INF;
  }
};

struct BiasMask {
  const float* tile;  // this edge tile's bias, (block_q, block_k)
  int row0;           // the warp's row 0 within the Q tile
  int block_q, block_k;
  __device__ __forceinline__ float operator()(int r, int j, float s) const {
    const int row = row0 + r;
    if (row >= block_q) return s;  // past the tile: never written
    return __fadd_rn(s, tile[row * block_k + j]);
  }
};

template <typename T, int D, bool BAND, bool STATE>
__global__ void __launch_bounds__(fa::THREADS)
    flash_attention_tiles_kernel(TilesArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* p_s = q_s + ROWS * D;
  T* kv_s = reinterpret_cast<T*>(p_s + ROWS * fa::BK_MAX);

  const int nsub = (a.block_q + ROWS - 1) / ROWS;
  const int i = blockIdx.x / nsub;
  const int sub0 = (blockIdx.x % nsub) * ROWS;  // first row within the tile
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int hk = h / (a.hq / a.hkv);
  const int q0 = i * a.block_q + sub0;
  // rows at or past qend are not ours (the last Q tile may be short)
  const int qend = min((i + 1) * a.block_q, a.lq);
  const size_t bh = (size_t)b * a.hq + h;
  const size_t bhk = (size_t)b * a.hkv + hk;
  const T* kb = a.k + bhk * a.lk * D;
  const T* vb = a.v + bhk * a.lk * D;

  fa::stage_q<T, D>(a.q + bh * a.lq * D, q0, qend, q_s);
  __syncthreads();

  const int warp_sub0 = sub0 + (threadIdx.x / 32) * fa::RPW;
  const bool warp_live = i * a.block_q + warp_sub0 < qend;
  const int start = a.rowp[i];
  const int midp = a.mid[i];
  const int stop = a.rowp[i + 1];
  const size_t tile = (size_t)a.block_k * D;
  const int last = (a.lk - 1) / a.block_k;  // the K tile that may be short
  const int last_keys = a.lk - last * a.block_k;

  fa::State<D> st;
  st.init();
  for (int p = start; p < midp; ++p) {
    const int c = a.cols[p];
    fa::fold_tile<T, D>(kb + c * tile, vb + c * tile,
                        c == last ? last_keys : a.block_k, a.scale,
                        warp_live, q_s, p_s, kv_s, st, fa::NoMask{});
  }
  for (int p = midp; p < stop; ++p) {
    const int c = a.cols[p];
    const int keys = c == last ? last_keys : a.block_k;
    if (BAND) {
      const BandMask mask{i * a.block_q + warp_sub0 + a.offset,
                          c * a.block_k, a.causal != 0, a.window};
      fa::fold_tile<T, D>(kb + c * tile, vb + c * tile, keys, a.scale,
                          warp_live, q_s, p_s, kv_s, st, mask);
    } else {
      const float* bias = a.biases + (size_t)(a.prowp[i] + (p - midp)) *
                                         a.block_q * a.block_k;
      const BiasMask mask{bias, warp_sub0, a.block_q, a.block_k};
      fa::fold_tile<T, D>(kb + c * tile, vb + c * tile, keys, a.scale,
                          warp_live, q_s, p_s, kv_s, st, mask);
    }
  }
  fa::flush<T, D>(st, q0, qend, a.o + bh * a.lq * D,
                  STATE ? a.m + bh * a.lq : nullptr,
                  STATE ? a.l + bh * a.lq : nullptr);
}


// The walk of Q tile i: its FULL tiles, then its PARTIAL ones, masked by
// the band compare (BAND) or by adding their stored bias tiles.
template <bool BAND>
struct TilesWalk {
  const int* cols;  // the Q tile's K tiles, cols[0 .. n)
  int n, nfull;     // tiles t >= nfull are PARTIAL
  int block_k;
  int causal, window, offset;  // the band
  const float* bias;  // the first PARTIAL tile's bias, (block_q, block_k)
  int qtile0, block_q;  // the Q tile's first row and its rows

  __device__ __forceinline__ int ntile() const { return n; }
  __device__ __forceinline__ int col(int t) const { return cols[t]; }
  __device__ __forceinline__ bool masked(int t) const { return t >= nfull; }
  __device__ __forceinline__ float mask(int t, int c, int row, int key,
                                        float x) const {
    if (BAND) {
      const int qb = row + offset;
      const int kpos = c * block_k + key;
      bool ok = true;
      if (causal) ok = qb >= kpos;
      if (window >= 0)
        ok = ok && (causal ? qb - kpos < window : abs(qb - kpos) < window);
      return ok ? x : fa::NEG_INF;
    }
    const int tr = row - qtile0;  // row in the Q tile
    if (tr >= block_q) return x;
    return __fadd_rn(x, bias[(size_t)(t - nfull) * block_q * block_k +
                             tr * block_k + key]);
  }
};

// One CTA per (Q tile, 128-row part of it, b, h); blockIdx.x runs h
// fastest, then b, then the position in ``order``.  blockDim.x is 128 x
// min(2, ceil(block_q / 64)).
template <int D, bool BAND, bool STATE>
__global__ void __launch_bounds__(tc::THREADS_MAX, 1)
    flash_attention_tiles_bf16_kernel(TilesArgs<__nv_bfloat16> a,
                                      const int* __restrict__ order,
                                      int batch) {
  const int rows_cta = blockDim.x / 2;  // 64 rows per 128 threads
  const int nsub = (a.block_q + rows_cta - 1) / rows_cta;
  int id = blockIdx.x;
  const int h = id % a.hq;
  id /= a.hq;
  const int b = id % batch;
  id /= batch;
  const int i = order[id / nsub];
  const int q0 = i * a.block_q + (id % nsub) * rows_cta;
  // rows at or past qend are not ours (the last Q tile may be short)
  const int qend = min(min((i + 1) * a.block_q, q0 + rows_cta), a.lq);
  if (q0 >= qend) return;  // the whole CTA, before any barrier

  const int hk = h / (a.hq / a.hkv);
  const size_t bh = (size_t)b * a.hq + h;
  const size_t bhk = (size_t)b * a.hkv + hk;
  const int start = a.rowp[i];
  const int midp = a.mid[i];
  const TilesWalk<BAND> walk{
      a.cols + start, a.rowp[i + 1] - start, midp - start, a.block_k,
      a.causal, a.window, a.offset,
      BAND ? nullptr
           : a.biases + (size_t)a.prowp[i] * a.block_q * a.block_k,
      i * a.block_q, a.block_q};
  tc::FoldOut dst{a.o + bh * a.lq * D, STATE ? a.m + bh * a.lq : nullptr,
                  STATE ? a.l + bh * a.lq : nullptr};
  dst.zero_dead = true;
  tc::fold_rows<D, STATE>(a.q + bh * a.lq * D, a.k + bhk * a.lk * D,
                          a.v + bhk * a.lk * D, dst, q0, qend, a.lk,
                          a.block_k, a.scale, walk);
}

template <typename T, int D, bool BAND, bool STATE>
int launch(const TilesArgs<T>& a, const int* order, int batch,
           cudaStream_t stream) {
  const int nq = (a.lq + a.block_q - 1) / a.block_q;
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const int wgs = std::min(tc::WG_MAX, (a.block_q + 63) / 64);
    const int nsub = (a.block_q + wgs * 64 - 1) / (wgs * 64);
    const long long blocks = (long long)nq * nsub * batch * a.hq;
    if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    const size_t bytes = tc::smem_bytes<D>(wgs * 64, a.block_k);
    auto kernel = flash_attention_tiles_bf16_kernel<D, BAND, STATE>;
    cudaError_t err = fa::allow_smem(kernel, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<static_cast<unsigned>(blocks), wgs * 128, bytes, stream>>>(
        a, order, batch);
  } else {
    const int nsub = (a.block_q + ROWS - 1) / ROWS;
    const dim3 grid(nq * nsub, a.hq, batch);
    const size_t bytes = fa::smem_bytes<T, D>();
    auto kernel = flash_attention_tiles_kernel<T, D, BAND, STATE>;
    cudaError_t err = fa::allow_smem(kernel, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, fa::THREADS, bytes, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_flags(const TilesArgs<T>& a, const int* order, int batch,
                 bool band, bool state, cudaStream_t s) {
  if (band)
    return state ? launch<T, D, true, true>(a, order, batch, s)
                 : launch<T, D, true, false>(a, order, batch, s);
  return state ? launch<T, D, false, true>(a, order, batch, s)
               : launch<T, D, false, false>(a, order, batch, s);
}

template <typename T>
int launch_dtype(TilesArgs<T> a, const int* order, int batch, int d,
                 bool band, bool state, cudaStream_t s) {
  switch (d) {
    case 32:
      return launch_flags<T, 32>(a, order, batch, band, state, s);
    case 64:
      return launch_flags<T, 64>(a, order, batch, band, state, s);
    case 96:
      return launch_flags<T, 96>(a, order, batch, band, state, s);
    case 112:
      return launch_flags<T, 112>(a, order, batch, band, state, s);
    case 128:
      return launch_flags<T, 128>(a, order, batch, band, state, s);
    case 256:
      return launch_flags<T, 256>(a, order, batch, band, state, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
TilesArgs<T> args(const void* rowp, const void* mid, const void* prowp,
                  const void* cols, const void* biases, const void* q,
                  const void* k, const void* v, void* o, void* m, void* l,
                  int hq, int hkv, int lq, int lk, int block_q, int block_k,
                  int causal, int window, int offset, float scale) {
  return TilesArgs<T>{static_cast<const int*>(rowp),
                      static_cast<const int*>(mid),
                      static_cast<const int*>(prowp),
                      static_cast<const int*>(cols),
                      static_cast<const float*>(biases),
                      static_cast<const T*>(q),
                      static_cast<const T*>(k),
                      static_cast<const T*>(v),
                      static_cast<T*>(o),
                      static_cast<float*>(m),
                      static_cast<float*>(l),
                      hq, hkv, lq, lk, block_q, block_k,
                      causal, window, offset, scale};
}

}  // namespace

// The layout arrays (int32 rowp (nq+1), mid (nq), prowp (nq), cols
// (ntiles), order (nq): the Q tiles by descending walk length; f32 biases
// (npart, block_q, block_k)) on the card; q (B, Hq, Lq, d), k / v (B, Hkv,
// Lk, d), o like q; m, l (B, Hq, Lq) f32 when state.  band = 1 masks
// PARTIAL tiles by (causal, window, offset), window < 0 for none; band = 0
// adds their bias tiles.  dtype 0 = f32 (the FMA fold; order unused), 1 =
// bf16 (the tensor cores; q, k, v 16-byte aligned).  The caller checks
// block_k <= 128, d in {32, 64, 96, 112, 128, 256}, and that the layout has at
// least one live tile.  The layout covers (Lq, Lk) in ceil-divided tiles:
// the last Q tile and the last K tile may be short.
extern "C" int flash_attention_tiles_launch(
    const void* rowp, const void* mid, const void* prowp, const void* cols,
    const void* biases, const void* order, const void* q, const void* k,
    const void* v, void* o, void* m, void* l, int batch, int hq, int hkv,
    int lq, int lk, int d, int block_q, int block_k, int band, int causal,
    int window, int offset, float scale, int state, int dtype,
    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ord = static_cast<const int*>(order);
  if (block_k < 1 || block_k > fa::BK_MAX || block_q < 1 || hkv < 1 ||
      hq % hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_dtype<float>(
        args<float>(rowp, mid, prowp, cols, biases, q, k, v, o, m, l, hq, hkv,
                    lq, lk, block_q, block_k, causal, window, offset, scale),
        ord, batch, d, band != 0, state != 0, s);
  if (dtype == 1)
    return launch_dtype<__nv_bfloat16>(
        args<__nv_bfloat16>(rowp, mid, prowp, cols, biases, q, k, v, o, m, l,
                            hq, hkv, lq, lk, block_q, block_k, causal, window,
                            offset, scale),
        ord, batch, d, band != 0, state != 0, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
