// The bf16 tensor-core fold shared by the dense grid
// (flash_attention.cu, flash_attention_bf16_kernel), the tile-skipping
// walk (flash_attention_tiles.cu, flash_attention_tiles_bf16_kernel) and
// the split-K key-length kernel's prefix regime (flash_attention_lens.cu,
// flash_attention_lens_prefix_kernel): the wgmma and cp.async helpers and
// fold_rows, which folds the K/V tiles of a walk into one CTA's Q rows and
// writes o (and m, l).  The kernels differ only in the walk (which K
// tiles, in which order) and the mask (which tiles it applies to, and
// how), so a row's arithmetic depends only
// on its q, the tiles it visits and their order: the dense causal grid and
// the tiles walk over causal_layout are bitwise equal in bf16, as the f32
// FMA fold (flash_attention.cuh) makes them in f32.
//
// Bound on this card: 4 * B * Hq * (live query-key pairs) * d flops at the
// bf16 tensor-core rate (989 TFLOP/s) against the bytes of q, k, v and o;
// at the prefill shape (B = 4, Hq = 16, L = 512, d = 128) 8.6 GFLOP
// non-causal, 8.7 us, and 128 us even at the f32 FMA peak, so the products
// must run on the tensor cores, and at their full rate only through wgmma.
// One CTA owns up to 128 Q rows, one warpgroup per 64 rows, so a 128-row
// CTA reads each K/V tile once (the f32 fold reads it 8 times).  Q, K and V
// are staged in shared memory by cp.async in wgmma's layout without
// swizzle (core matrices of 8 rows x 16 bytes), K and V in a ring of
// stages<D>() stages (two up to d = 128, one at d = 256), so the next tile
// loads while this one is folded; the short last tile and the padding are
// zero-filled.  S = Q K^T is one wgmma m64n128k16 per 16 of d (m64n64k16
// for tiles of at most 64 keys) with both operands in shared memory; the
// mask and the online softmax run on the S accumulators in registers; P is
// rounded to bf16 (round to nearest even) and is, fragment for fragment,
// the register A operand of P V, m64n{d}k16 per 16 keys with V as the
// transposed B operand (d = 32, 64, 96, 112, 128 or 256; at 112 a row is
// 224 bytes, 14 core-matrix columns, and S = Q K^T takes 7 k16 steps).  o
// is accumulated in f32 and rounded once, or written as an unnormalised f32
// partial for a split-K merge (FoldOut).  The recurrence and its rounding points are
// fa::fold_tile's: s = (q . k) * scale, masked; m, alpha, p and l with
// expf and explicit round-to-nearest ops; acc = acc * alpha + P V.  The
// two warpgroups run S, softmax and P V in step, so the tensor cores idle
// during the softmax; PERF.md has the times.  At d = 256 a thread holds
// 128 o and 64 S accumulators and spills 72-248 bytes.  A variant without
// spills, which walked the tiles twice with half of o's columns a pass
// (recomputing S), measured 1.26-1.41x slower; PERF.md has the counts.
#pragma once

#include "flash_attention.cuh"

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

// d += A B, m64n96k16: A from registers, B from shared memory
// (MN-major, transposed)
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
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
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// d += A B, m64n112k16: A from registers, B from shared memory
// (MN-major, transposed)
__device__ __forceinline__ void wgmma_rs_n112(float (&d)[56],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
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
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// d += A B, m64n256k16: A from registers, B from shared memory
// (MN-major, transposed)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}


// o += P V for head_dim D: m64n{D}k16 with P from registers
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  static_assert(D == 32 || D == 64 || D == 96 || D == 112 || D == 128 ||
                    D == 256,
                "head_dim");
  if constexpr (D == 32)
    wgmma_rs_n32(d, a, db);
  else if constexpr (D == 64)
    wgmma_rs_n64(d, a, db);
  else if constexpr (D == 96)
    wgmma_rs_n96(d, a, db);
  else if constexpr (D == 112)
    wgmma_rs_n112(d, a, db);
  else if constexpr (D == 128)
    wgmma_rs_n128(d, a, db);
  else
    wgmma_rs_n256(d, a, db);
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

// The K/V ring's stages by head_dim: two (tile t + 1 loads while tile t
// folds) up to d = 128; one at d = 256, where two stages of 128-key K and
// V tiles and 128 Q rows would take 320 KB, over the 227 KB a CTA may use.
// With one stage, K of tile t + 1 loads during the softmax and P V of tile
// t, and V of tile t + 1 during the next S = Q K^T.
template <int D>
__host__ __device__ constexpr int stages() {
  return D > 128 ? 1 : 2;
}

// Dynamic shared memory: Q (rows), then stages<D>() stages of K and of V
// (bkc keys each, bkc = block_k rounded up to 64), all D wide: 160 KB at
// 128 rows, 128 keys and d = 128; 192 KB at d = 256 (one stage).
template <int D>
size_t smem_bytes(int rows, int block_k) {
  const int bkc = (block_k + CHUNK - 1) / CHUNK * CHUNK;
  return sizeof(bf16) * (size_t)(rows + 2 * stages<D>() * bkc) * D;
}

// Where fold_rows writes its result.  By default o = acc / max(l, 1e-30)
// rounded to bf16 (out, row 0 of the CTA's (b, h)) and, when STATE, m and
// l (m_out, l_out); with acc set, the unnormalised f32 partial of a split
// instead: acc (row - q0, D) row-major, m and l at row - q0 (a split-K
// kernel merges such partials, flash_attention_lens.cu).
struct FoldOut {
  bf16* out;
  float* m_out;
  float* l_out;
  float* acc = nullptr;
  float* acc_m = nullptr;
  float* acc_l = nullptr;
  // o = 0 on a row with no live key (m == NEG_INF), where acc / l would
  // be the mean of the walked V rows: the differentiable walks (the dense
  // grid and tiles) set it, so that o agrees with their backward
  bool zero_dead = false;
};

// One CTA's fold over a walk.  blockDim.x is 128 x (1 or 2): warpgroup w
// owns rows q0 + 64w .. q0 + 64w + 63, of which those below qend are real.
// q points at row 0 of the CTA's (b, h) (or of its rows), kb / vb at key 0
// of its kv-head; the result goes to `dst` (FoldOut).  The walk visits
// walk.ntile() K tiles, tile t being K tile walk.col(t) (keys col * block_k
// on, the last K tile of lk keys may be short); where walk.masked(t), the
// scaled score x of row `row` (counted from q) and key `key` of the tile
// becomes walk.mask(t, c, row, key, x).  In a warpgroup's accumulators (S,
// o), lane (g = lane / 4, tq = lane % 4) of its warp w4 holds rows
// 16 w4 + g and 16 w4 + g + 8, and columns 8j + 2tq and 8j + 2tq + 1 of
// each block j of 8 in registers 4j .. 4j + 3.  Every thread of the CTA
// calls it.
template <int D, bool STATE, class Walk>
__device__ __forceinline__ void fold_rows(const bf16* __restrict__ q,
                                          const bf16* __restrict__ kb,
                                          const bf16* __restrict__ vb,
                                          const FoldOut& dst, int q0,
                                          int qend, int lk, int block_k,
                                          float scale, const Walk& walk) {
  constexpr int KD = D / 16;  // k16 steps over d
  constexpr int NO = D / 2;   // o registers per thread
  constexpr int KC = fa::BK_MAX / 16;  // k16 steps of P V, at most
  constexpr int NS = stages<D>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows_cta = blockDim.x / 2;  // 64 rows per 128 threads
  const int bkc = (block_k + CHUNK - 1) / CHUNK * CHUNK;
  const int bkp = (block_k + 15) & ~15;  // keys that P V reads
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + rows_cta * D;  // stage s at k_s + s * bkc * D
  bf16* v_s = k_s + NS * bkc * D;
  const int ntile = walk.ntile();
  const int last = (lk - 1) / block_k;  // the K tile that may be short
  const int last_keys = lk - last * block_k;

  load_rows<D>(q_s, q + (size_t)q0 * D, rows_cta, rows_cta, qend - q0);
  cp_commit();
  // K (bkc keys) or V (bkp keys) of tile t of the walk into stage t % NS,
  // one group each, zero past the tile's keys (an empty group past the
  // walk keeps the count of pending groups fixed)
  auto issue = [&](int t, bool values) {
    if (t < ntile) {
      const int c = walk.col(t);
      const int keys = c == last ? last_keys : block_k;
      const size_t off = (size_t)c * block_k * D;
      const int st = NS == 2 ? (t & 1) : 0;
      if (values)
        load_rows<D>(v_s + st * bkc * D, vb + off, bkp, bkc, keys);
      else
        load_rows<D>(k_s + st * bkc * D, kb + off, bkc, bkc, keys);
    }
    cp_commit();
  };
  issue(0, false);
  issue(0, true);
  cp_wait<2>();  // Q has landed
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
  const uint64_t dq = desc(q_s + wg * 64 * 8, rows_cta * 16, 128);

  float o[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j] = 0.f;
  float m_r[2] = {fa::NEG_INF, fa::NEG_INF};
  float l_r[2] = {0.f, 0.f};
  const float kDrop = __int_as_float(0xff800000);  // -inf: not a key

  for (int t = 0; t < ntile; ++t) {
    // pending groups here: K(t), V(t) (and K(t + 1), V(t + 1) once issued
    // with two stages)
    if constexpr (NS == 2) {
      issue(t + 1, false);
      issue(t + 1, true);
      cp_wait<3>();  // K of tile t
    } else {
      cp_wait<1>();  // K of tile t
    }
    __syncthreads();
    const int c = walk.col(t);
    const int keys = c == last ? last_keys : block_k;
    const int st = NS == 2 ? (t & 1) : 0;
    const bf16* ks = k_s + st * bkc * D;
    const bf16* vs = v_s + st * bkc * D;
    uint32_t pa[KC][4];
    // S in registers: key 8 (e / 4) + 2tq + (e & 1) of register e
    float s[2 * 32];
    if (live) {
      // S = Q K^T: K is the K-major B operand; one n128 product for a
      // 128-key tile, else n64 ones
#pragma unroll
      for (int e = 0; e < 64; ++e) s[e] = 0.f;
      const uint64_t dk = desc(ks, bkc * 16, 128);
      wg_fence();
      if (bkc == 2 * CHUNK) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          wgmma_ss_n128(s, dq + kk * (2 * rows_cta), dk + kk * (2 * bkc),
                        kk > 0);
      } else {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          wgmma_ss_n64(*reinterpret_cast<float(*)[32]>(s),
                       dq + kk * (2 * rows_cta), dk + kk * (2 * bkc),
                       kk > 0);
      }
      wg_commit_wait();
    }
    if constexpr (NS == 1) {
      __syncthreads();      // every warpgroup is done with K of tile t
      issue(t + 1, false);  // pending: V(t), K(t + 1)
    }
    if (live) {
      // scale and mask; keys past the tile's count drop out (-inf, so
      // that they take no part in the max and p = 0)
      const bool masked = walk.masked(t);
      float mx[2] = {kDrop, kDrop};
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        const int key = 8 * (e / 4) + 2 * tq + (e & 1);
        const int row = row0 + 8 * ((e >> 1) & 1);
        float x = kDrop;
        if (key < keys) {
          x = __fmul_rn(s[e], scale);
          if (masked) x = walk.mask(t, c, row, key, x);
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
        pa[m][0] = pack(s[8 * m], s[8 * m + 1]);
        pa[m][1] = pack(s[8 * m + 2], s[8 * m + 3]);
        pa[m][2] = pack(s[8 * m + 4], s[8 * m + 5]);
        pa[m][3] = pack(s[8 * m + 6], s[8 * m + 7]);
      }
    }
    if constexpr (NS == 2)
      cp_wait<2>();  // V of tile t
    else
      cp_wait<1>();  // V of tile t
    __syncthreads();
    if (live) {
      // o += P V: V is the MN-major B operand (keys along K); a k16 step
      // is two key blocks on
      const uint64_t dv = desc(vs, 128, bkc * 16);
      wg_fence();
#pragma unroll
      for (int m = 0; m < KC; ++m)
        if (16 * m < bkp) wgmma_pv<D>(o, pa[m], dv + m * 16);
      wg_commit_wait();
    }
    __syncthreads();  // the stage is free for the next tile that uses it
    if constexpr (NS == 1) issue(t + 1, true);  // pending: K, V(t + 1)
  }

  // o = acc / max(l, 1e-30), rounded once (0 on a dead row when
  // dst.zero_dead), and the state (m, l) when asked; or the unnormalised
  // f32 partial
  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= qend) continue;
    if (dst.acc != nullptr) {
      float* a = dst.acc + (size_t)(row - q0) * D + 2 * tq;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(a + 8 * j) =
            make_float2(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
      if (tq == 0) {
        dst.acc_m[row - q0] = m_r[r];
        dst.acc_l[row - q0] = l_r[r];
      }
      continue;
    }
    const float denom = fmaxf(l_r[r], 1e-30f);
    const bool zero = dst.zero_dead && m_r[r] <= fa::NEG_INF;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst.out + (size_t)row * D + 8 * j +
                                         2 * tq) =
          zero ? __floats2bfloat162_rn(0.f, 0.f)
               : __floats2bfloat162_rn(__fdiv_rn(o[4 * j + 2 * r], denom),
                                       __fdiv_rn(o[4 * j + 2 * r + 1],
                                                 denom));
    if (STATE && tq == 0) {
      dst.m_out[row] = m_r[r];
      dst.l_out[row] = l_r[r];
    }
  }
}

}  // namespace tc
