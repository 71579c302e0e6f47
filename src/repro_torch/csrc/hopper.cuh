// Hopper building blocks shared by the port's TMA + wgmma kernels (K6's bf16
// route in matmul_fused.cu, K7's in flash_attention.cu and its backward's in
// flash_attention_bwd.cu, K9's prefill route in moe_gmm.cu and its
// backward's in moe_gmm_bwd.cu): mbarriers, TMA loads and stores, 128-byte-swizzle
// shared-memory descriptors, the wgmma instances the kernels use, and the
// host-side tensor-map encoder.  Every source that includes it builds into
// its own library (kernels/_build.py hashes it with the source), so nothing
// here needs external linkage.
//
// Layout conventions (bf16, 128-byte swizzle): a box is 64 elements of its
// innermost dimension (128 bytes) by up to 256 rows; 8 rows make a 1 KB
// swizzle atom, so every box starts on a 1 KB boundary.
//   * K-major operand (the reduction dimension innermost: a, q, k): 16 k =
//     32 bytes along the row; the next 64 k lie in the next box.
//   * MN-major operand (the output columns innermost: b, v, read through the
//     transpose bit): 16 k = 16 rows = 2 KB on; 64-column boxes lie `box`
//     bytes apart (the descriptor's leading offset).
#pragma once

#include <cstdint>

#include <cuda.h>  // CUtensorMap and its enums only: no libcuda call is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace hopper {
namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Spins until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// Initialises barriers from one thread, then makes them visible to the
// async proxy (TMA); the caller synchronises the block after.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One TMA load of the box at (c0 innermost, c1) of `map` into dst; its
// bytes complete a transaction on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// The same for a 3-D map: (c0 innermost, c1, c2).
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// One TMA store of the box at src (shared) to (c0 innermost, c1) of `map`;
// the parts of the box past the tensor's edges are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

// The same for a 3-D map.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Makes this thread's shared-memory writes visible to TMA.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Commits this thread's TMA stores as a group; a store that overlaps later
// work is committed here and waited for by tma_store_wait_read ...
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// ... before its shared memory is written again or the block ends: until
// every committed group has read it.
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Commits this thread's TMA stores and waits until they have read shared
// memory (before it is reused or the block ends).
__device__ __forceinline__ void tma_store_wait() {
  tma_store_commit();
  tma_store_wait_read();
}

// Byte offset, inside a run of 64-column boxes in the 128-byte swizzle, of
// the bf16 pair at (row r of the box, column col of the run); `box` is the
// bytes of one box.
__device__ __forceinline__ int sw128_at(int r, int col, int box) {
  const int cb = col % 64;
  return (col / 64) * box + r * 128 + (((cb / 8) ^ (r % 8)) * 16) + (cb % 8) * 2;
}

// A wgmma shared-memory descriptor with 128-byte swizzle: start address,
// leading and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Ties registers that a wgmma wrote (or read) to this point of the program,
// so the compiler moves no access to them across a wgmma_wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// The accumulator fragment of every wgmma m64nN f32 instance: thread t of
// the warpgroup holds rows 16*(t/32) + (t%32)/4 (+ 8) and, for j < N/8, the
// column pairs 8*j + 2*(t%4): d[4j], d[4j+1] on the first row, d[4j+2],
// d[4j+3] on the second.

#define REPRO_WGMMA_D64                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "          \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "          \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define REPRO_WGMMA_D32                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define REPRO_WGMMA_OUT32(d)                                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),         \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define REPRO_WGMMA_OUT64(d)                                                                      \
  REPRO_WGMMA_OUT32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),      \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),           \
      "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),           \
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),           \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),           \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d (64 x 128 f32) = (accumulate ? d : 0) + a (64 x 16, K-major) x b (16 x
// 128, MN-major: the transpose bit is set).  K9's mainloop at bm 64, with
// d = 0 at the first k step, so no instruction but wgmma defines it.
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16\n" REPRO_WGMMA_D64
      ",\n"
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : REPRO_WGMMA_OUT64(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += a x b as above: K6's mainloop.
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da, uint64_t db) {
  wgmma_bf16(d, da, db, 1);
}

#define REPRO_WGMMA_D128                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "          \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "          \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "          \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "          \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "          \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "           \
  "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "      \
  "%124, %125, %126, %127}"
#define REPRO_WGMMA_OUT128(d)                                                                     \
  REPRO_WGMMA_OUT64(d), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]),      \
      "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),           \
      "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),           \
      "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]),           \
      "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]),           \
      "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]),           \
      "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),      \
      "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]),     \
      "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]),     \
      "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]),     \
      "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])

// d (64 x 256 f32) = (accumulate ? d : 0) + a (64 x 16, K-major) x b (16 x
// 256, MN-major).  K9's mainloop at bm a multiple of 128.
__device__ __forceinline__ void wgmma_bf16(float (&d)[128], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16\n" REPRO_WGMMA_D128
      ",\n"
      "%128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : REPRO_WGMMA_OUT128(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 256 f32) = (accumulate ? d : 0) + a (64 x 16, K-major) x b (16 x
// 256, K-major: b's rows are the 256 output columns, the k innermost).
// K9' (dtokens): dout x W[e]^T, W[e] read as it lies.
__device__ __forceinline__ void wgmma_bf16_kk(float (&d)[128], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16\n" REPRO_WGMMA_D128
      ",\n"
      "%128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : REPRO_WGMMA_OUT128(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 256 f32) = (accumulate ? d : 0) + a (64 x 16, M-major: the
// transpose bit is set) x b (16 x 256, MN-major).  K9' (dweights): tokens^T
// x dout, both read as they lie (64 rows of tokens by 64 of D, 64 rows of
// dout by 256 of F), in the MN-major layout of the 128-byte swizzle.
__device__ __forceinline__ void wgmma_bf16_tt(float (&d)[128], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16\n" REPRO_WGMMA_D128
      ",\n"
      "%128, %129, p, 1, 1, 1, 1;\n"
      "}\n"
      : REPRO_WGMMA_OUT128(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 32 f32) = (accumulate ? d : 0) + a (64 x 16, K-major) x b (16 x
// 32, K-major).  K7's backward: S^T = K Q^T and dP^T = V dout^T over a step
// of 32 queries.
__device__ __forceinline__ void wgmma_bf16_kk(float (&d)[16], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},\n"
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64 f32) = (accumulate ? d : 0) + a (64 x 16, K-major) x b (16 x
// 64, K-major: b's rows are the 64 output columns, the k innermost).  K7's
// S = Q K^T over a block of 64 keys; its backward's S, dP = dout V^T and
// their transposes over 64 queries.
__device__ __forceinline__ void wgmma_bf16_kk(float (&d)[32], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16\n" REPRO_WGMMA_D32
      ",\n"
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : REPRO_WGMMA_OUT32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// The same at N = 128: K7's S over a block of 128 keys.
__device__ __forceinline__ void wgmma_bf16_kk(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16\n" REPRO_WGMMA_D64
      ",\n"
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : REPRO_WGMMA_OUT64(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128 f32) += a (64 x 16 bf16 in registers, the fragment of
// mma.sync m16n8k16's A on each warp's 16 rows) x b (16 x 128, MN-major).
// K7's O += P V at Dh 128; its backward's dQ += dS K, dV += P^T dout and
// dK += dS^T Q.
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16\n" REPRO_WGMMA_D64
      ",\n"
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : REPRO_WGMMA_OUT64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The same at N = 64: K7's O += P V at Dh 64.
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16\n" REPRO_WGMMA_D32
      ",\n"
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : REPRO_WGMMA_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef REPRO_WGMMA_D128
#undef REPRO_WGMMA_D64
#undef REPRO_WGMMA_D32
#undef REPRO_WGMMA_OUT32
#undef REPRO_WGMMA_OUT64
#undef REPRO_WGMMA_OUT128

// ---- host: tensor maps ---------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda the runtime has loaded, or null.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &sym, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(sym);
  }
  return fn;
}

// A 2-D bf16 tensor map of a row-major (rows, cols) matrix, boxes of
// box_rows x box_cols (box_cols * 2 = 128 bytes), 128-byte swizzle, zero
// fill out of bounds.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* base, int64_t rows, int64_t cols,
            uint32_t box_rows, uint32_t box_cols) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 3-D bf16 tensor map of a row-major (mats, rows, cols) array, boxes of
// one matrix x box_rows x box_cols (box_cols * 2 = 128 bytes), 128-byte
// swizzle, zero fill out of bounds: a box past `rows` reads zeros, never the
// next matrix's rows, and a store drops them.
bool encode_3d(EncodeTiled fn, CUtensorMap* map, const void* base, int64_t mats, int64_t rows,
               int64_t cols, uint32_t box_rows, uint32_t box_cols) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(mats)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 2,
                                 static_cast<cuuint64_t>(rows * cols) * 2};
  const cuuint32_t box[3] = {box_cols, box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
}  // namespace hopper
