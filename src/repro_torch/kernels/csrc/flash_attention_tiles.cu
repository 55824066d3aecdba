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
// no live K tile output 0 with m = NEG_INF and l = 0.  The kernel is chosen
// by dtype: f32 keeps the FMA fold, bf16 runs on the tensor cores.
//
// f32.  One CTA owns fa::ROWS rows (a Q tile of block_q rows is cut into
// ceil(block_q / ROWS) CTAs).  Every tile is folded by fa::fold_tile, as in
// flash_attention.cu, and the causal layout lists a Q tile's K tiles in
// ascending order, as the dense grid visits them; so over causal_layout
// this kernel is bitwise equal to flash_attention_kernel with causal = true
// in f32.  Tensor cores would run f32 as TF32 and lose that.
//
// bf16.  Bound on this card: 4 * B * Hq * (live query-key pairs) * d flops
// at the bf16 tensor-core rate against the bytes of q, k, v, o; at the
// prefill shape (B = 4, Hq = 16, L = 512, d = 128, causal) 4.3 GFLOP, about
// 4.4 us at 989 TFLOP/s, and 64 us even at the f32 FMA peak, so the
// products must run on the tensor cores, and at their full rate only
// through wgmma.  One CTA owns up to 128 rows of a Q tile, one warpgroup
// per 64 rows, so a 128-row tile reads each K/V tile once (the f32 fold
// reads it 8 times).  Q, K and V are staged in shared memory by cp.async in
// wgmma's layout without swizzle (core matrices of 8 rows x 16 bytes), K
// and V in a two-stage ring, so the next tile loads while this one is
// folded; the short last tile and the padding are zero-filled.  S = Q K^T
// is one wgmma m64n128k16 per 16 of d (m64n64k16 for tiles of at most 64
// keys) with both operands in shared memory; the mask and the online
// softmax run on the S accumulators in registers; P is rounded to bf16
// (round to nearest even) and is, fragment for fragment, the register A
// operand of P V, m64n{d}k16 per 16 keys with V as the transposed B operand.
// o is accumulated in f32 and rounded once.  The recurrence and its
// rounding points are fa::fold_tile's: s = (q . k) * scale, masked; m,
// alpha, p and l with expf and explicit round-to-nearest ops; acc = acc *
// alpha + P V.  The CTAs of the Q tiles with the longest walks start first
// (``order``, from the wrapper).  The two warpgroups run S, softmax and P V
// in step, so the tensor cores idle during the softmax: overlapping them
// (warp specialisation, TMA) is the next step; PERF.md has the times.  The
// layout's index arrays stay on the card (the wrapper caches them per
// layout and device).
#include <limits.h>

#include <algorithm>
#include <type_traits>

#include "flash_attention.cuh"

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

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int WG_MAX = 2;                   // warpgroups (64 Q rows each)
constexpr int THREADS_MAX = WG_MAX * 128;
constexpr int CHUNK = 64;  // K tiles are staged in multiples of 64 keys

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's cp.async groups are pending, then
// make its copies visible to the tensor cores' (async proxy) reads
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A wgmma shared-memory descriptor without swizzle: the operand is stored
// as core matrices of 8 rows x 16 bytes, each 128 contiguous bytes; lbo is
// the byte stride between core matrices along K, sbo along M (or N).
__device__ __forceinline__ uint64_t desc(const void* p, int lbo, int sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (+)= A B^T, m64n64k16: A and B from shared memory (K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate)
      : "memory");
}

// d (+)= A B^T, m64n128k16: A and B from shared memory (K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate)
      : "memory");
}

// d += A B, m64n32k16: A from registers, B from shared memory
// (MN-major, transposed)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// d += A B, m64n64k16: A from registers, B from shared memory
// (MN-major, transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// d += A B, m64n128k16: A from registers, B from shared memory
// (MN-major, transposed)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}


template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 32)
    wgmma_rs_n32(d, a, db);
  else if constexpr (D == 64)
    wgmma_rs_n64(d, a, db);
  else
    wgmma_rs_n128(d, a, db);
}

// two f32 -> bf16x2 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Copy `rows` rows of D bf16 (row stride D in global) into the core-matrix
// layout with `cap` rows: the 16 bytes of row r, columns 8c .. 8c + 7 go to
// byte c * cap * 16 + r * 16, so a column block of 8 rows is one core
// matrix and core matrices are 128 bytes apart along the rows and cap * 16
// along the columns.  Rows at or past nvalid are zero-filled.  A thread
// takes two neighbouring 16-byte chunks of a row (one 32-byte sector) and
// a warp's 32 chunks land in 4 shared-memory wavefronts.  Every thread of
// the CTA calls it.
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int rows, int cap, int nvalid) {
  unsigned char* base = reinterpret_cast<unsigned char*>(dst);
  for (int e = threadIdx.x; e < rows * (D / 8); e += blockDim.x) {
    const int rest = e >> 1;
    const int r = rest % rows;
    const int c = 2 * (rest / rows) + (e & 1);
    const bool ok = r < nvalid;
    cp_async16(base + (size_t)c * cap * 16 + r * 16,
               src + (size_t)(ok ? r : 0) * D + c * 8, ok);
  }
}

// Dynamic shared memory: Q (rows), then two stages of K and of V (bkc keys
// each, bkc = block_k rounded up to 64), all D wide: 160 KB at 128 rows,
// 128 keys and d = 128.
template <int D>
size_t smem_bytes(int rows, int block_k) {
  const int bkc = (block_k + CHUNK - 1) / CHUNK * CHUNK;
  return sizeof(bf16) * (size_t)(rows + 4 * bkc) * D;
}

}  // namespace tc

// One CTA per (Q tile, 128-row part of it, b, h); blockIdx.x runs h
// fastest, then b, then the position in ``order``.  blockDim.x is 128 x
// min(2, ceil(block_q / 64)): warpgroup w owns rows 64w .. 64w + 63.  In a
// warpgroup's accumulators (S, o), lane (g = lane / 4, tq = lane % 4) of
// its warp w4 holds rows 16 w4 + g and 16 w4 + g + 8, and columns 8j + 2tq
// and 8j + 2tq + 1 of each block j of 8 in registers 4j .. 4j + 3.
template <int D, bool BAND, bool STATE>
__global__ void __launch_bounds__(tc::THREADS_MAX, 1)
    flash_attention_tiles_bf16_kernel(TilesArgs<__nv_bfloat16> a,
                                      const int* __restrict__ order,
                                      int batch) {
  using tc::bf16;
  constexpr int KD = D / 16;  // k16 steps over d
  constexpr int NO = D / 2;   // o registers per thread
  constexpr int KC = fa::BK_MAX / 16;  // k16 steps of P V, at most
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows_cta = blockDim.x / 2;  // 64 rows per 128 threads
  const int bkc = (a.block_k + tc::CHUNK - 1) / tc::CHUNK * tc::CHUNK;
  const int bkp = (a.block_k + 15) & ~15;  // keys that P V reads
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + rows_cta * D;  // stage s at k_s + s * bkc * D
  bf16* v_s = k_s + 2 * bkc * D;

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
  const bf16* kb = a.k + bhk * a.lk * D;
  const bf16* vb = a.v + bhk * a.lk * D;
  const int start = a.rowp[i];
  const int midp = a.mid[i];
  const int ntile = a.rowp[i + 1] - start;
  const int last = (a.lk - 1) / a.block_k;  // the K tile that may be short
  const int last_keys = a.lk - last * a.block_k;

  tc::load_rows<D>(q_s, a.q + (bh * a.lq + q0) * D, rows_cta, rows_cta,
                   qend - q0);
  tc::cp_commit();
  // tile t of the walk into stage t % 2: K (bkc keys), then V (bkp keys),
  // one group each, zero past the tile's keys (empty groups past the walk
  // keep the count of pending groups fixed)
  auto issue = [&](int t) {
    if (t < ntile) {
      const int c = a.cols[start + t];
      const int keys = c == last ? last_keys : a.block_k;
      const size_t off = (size_t)c * a.block_k * D;
      tc::load_rows<D>(k_s + (t & 1) * bkc * D, kb + off, bkc, bkc, keys);
      tc::cp_commit();
      tc::load_rows<D>(v_s + (t & 1) * bkc * D, vb + off, bkp, bkc, keys);
    } else {
      tc::cp_commit();
    }
    tc::cp_commit();
  };
  issue(0);
  tc::cp_wait<2>();  // Q has landed
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int wgrow = q0 + wg * 64;  // the warpgroup's first row
  const bool live = wgrow < qend;  // uniform over the warpgroup
  const int row0 = wgrow + (threadIdx.x / 32 % 4) * 16 + g;
  // the warpgroup's Q rows as the K-major A operand; a k16 step is two
  // column blocks on
  const uint64_t dq = tc::desc(q_s + wg * 64 * 8, rows_cta * 16, 128);

  float o[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j] = 0.f;
  float m_r[2] = {fa::NEG_INF, fa::NEG_INF};
  float l_r[2] = {0.f, 0.f};
  const float kDrop = __int_as_float(0xff800000);  // -inf: not a key

  for (int t = 0; t < ntile; ++t) {
    issue(t + 1);
    tc::cp_wait<3>();  // K of tile t
    __syncthreads();
    const int p = start + t;
    const int c = a.cols[p];
    const int keys = c == last ? last_keys : a.block_k;
    const bf16* ks = k_s + (t & 1) * bkc * D;
    const bf16* vs = v_s + (t & 1) * bkc * D;
    uint32_t pa[KC][4];
    // S in registers: key 8 (e / 4) + 2tq + (e & 1) of register e
    float s[2 * 32];
    if (live) {
      // S = Q K^T: K is the K-major B operand; one n128 product for a
      // 128-key tile, else n64 ones
#pragma unroll
      for (int e = 0; e < 64; ++e) s[e] = 0.f;
      const uint64_t dk = tc::desc(ks, bkc * 16, 128);
      tc::wg_fence();
      if (bkc == 2 * tc::CHUNK) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          tc::wgmma_ss_n128(s, dq + kk * (2 * rows_cta), dk + kk * (2 * bkc),
                            kk > 0);
      } else {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          tc::wgmma_ss_n64(*reinterpret_cast<float(*)[32]>(s),
                           dq + kk * (2 * rows_cta), dk + kk * (2 * bkc),
                           kk > 0);
      }
      tc::wg_commit_wait();

      // scale and mask; keys past the tile's count drop out (-inf, so
      // that they take no part in the max and p = 0)
      const bool partial = p >= midp;
      float mx[2] = {kDrop, kDrop};
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        const int key = 8 * (e / 4) + 2 * tq + (e & 1);
        const int row = row0 + 8 * ((e >> 1) & 1);
        float x = kDrop;
        if (key < keys) {
          x = __fmul_rn(s[e], a.scale);
          if (partial) {
            if (BAND) {
              const int qb = row + a.offset;
              const int kpos = c * a.block_k + key;
              bool ok = true;
              if (a.causal) ok = qb >= kpos;
              if (a.window >= 0)
                ok = ok && (a.causal ? qb - kpos < a.window
                                     : abs(qb - kpos) < a.window);
              x = ok ? x : fa::NEG_INF;
            } else {
              const int tr = row - i * a.block_q;  // row in the Q tile
              const float* bias =
                  a.biases + (size_t)(a.prowp[i] + (p - midp)) *
                                 a.block_q * a.block_k;
              if (tr < a.block_q)
                x = __fadd_rn(x, bias[tr * a.block_k + key]);
            }
          }
        }
        s[e] = x;
        mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], x);
      }
      float alpha[2], ps[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_cur = fmaxf(m_r[r], mx[r]);
        alpha[r] = expf(__fsub_rn(m_r[r], m_cur));
        m_r[r] = m_cur;
        ps[r] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        const int r = (e >> 1) & 1;
        const float pr = expf(__fsub_rn(s[e], m_r[r]));
        ps[r] = __fadd_rn(ps[r], pr);
        s[e] = pr;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        ps[r] = __fadd_rn(ps[r], __shfl_xor_sync(0xffffffffu, ps[r], 1));
        ps[r] = __fadd_rn(ps[r], __shfl_xor_sync(0xffffffffu, ps[r], 2));
        l_r[r] = __fadd_rn(__fmul_rn(l_r[r], alpha[r]), ps[r]);
      }
#pragma unroll
      for (int j = 0; j < NO; ++j)
        o[j] = __fmul_rn(o[j], alpha[(j >> 1) & 1]);
      // P rounded to bf16: the S accumulators of key blocks 2m and 2m + 1
      // are the register A operand of keys 16m .. 16m + 15
#pragma unroll
      for (int m = 0; m < KC; ++m) {
        pa[m][0] = tc::pack(s[8 * m], s[8 * m + 1]);
        pa[m][1] = tc::pack(s[8 * m + 2], s[8 * m + 3]);
        pa[m][2] = tc::pack(s[8 * m + 4], s[8 * m + 5]);
        pa[m][3] = tc::pack(s[8 * m + 6], s[8 * m + 7]);
      }
    }
    tc::cp_wait<2>();  // V of tile t
    __syncthreads();
    if (live) {
      // o += P V: V is the MN-major B operand (keys along K); a k16 step
      // is two key blocks on
      const uint64_t dv = tc::desc(vs, 128, bkc * 16);
      tc::wg_fence();
#pragma unroll
      for (int m = 0; m < KC; ++m)
        if (16 * m < bkp) tc::wgmma_pv<D>(o, pa[m], dv + m * 16);
      tc::wg_commit_wait();
    }
    __syncthreads();  // stage t % 2 is free for tile t + 2
  }

  // o = acc / max(l, 1e-30), rounded once; the state (m, l) when asked
  if (!live) return;
  bf16* out = a.o + bh * a.lq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= qend) continue;
    const float denom = fmaxf(l_r[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * D + 8 * j +
                                         2 * tq) =
          __floats2bfloat162_rn(__fdiv_rn(o[4 * j + 2 * r], denom),
                                __fdiv_rn(o[4 * j + 2 * r + 1], denom));
    if (STATE && tq == 0) {
      a.m[bh * a.lq + row] = m_r[r];
      a.l[bh * a.lq + row] = l_r[r];
    }
  }
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
    case 128:
      return launch_flags<T, 128>(a, order, batch, band, state, s);
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
// block_k <= 128, d in {32, 64, 128}, and that the layout has at least one
// live tile.  The layout covers (Lq, Lk) in ceil-divided tiles: the last Q
// tile and the last K tile may be short.
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
