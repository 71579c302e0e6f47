// The cp.async staging, the bf16 tensor-core product (mma.sync m16n8k16,
// f32 sums) and the warp tiles of a four-warp tiled GEMM (bf16 on the
// tensor cores, f32 on the SIMT cores) shared by K9's "mma" route
// (moe_gmm.cu) and its backward (moe_gmm_bwd.cu).
//
// Everything here lives in an anonymous namespace: each source that
// includes it is its own library.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; bytes past src_bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float zero_of(float) { return 0.f; }
__device__ __forceinline__ __nv_bfloat16 zero_of(__nv_bfloat16) { return __float2bfloat16(0.f); }
__device__ __forceinline__ void store_bf16(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// One 16-byte chunk of a row: `valid` of its elements lie in bounds (the
// rest read as zero).  `src` must be a readable address even when valid is 0.
template <typename T>
__device__ __forceinline__ void load_chunk(T* dst, const T* src, int valid, bool vec) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  if (vec) {
    cp_async16(dst, src, valid * static_cast<int>(sizeof(T)));
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) dst[j] = j < valid ? src[j] : zero_of(T());
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// d += a (16 x 16, row) x b (16 x 8, col), bf16 operands, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr int kThreads = 128;  // four warps a block of the tiled GEMMs

// A stage of a ring: an A slice of AR x AC and a B slice of BR x BC
// elements, rows padded by 16 bytes (both ldmatrix forms conflict-free).
template <typename T, int AR, int AC, int BR, int BC, int STAGES>
struct Smem {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  static constexpr int kAStride = AC + kVec;
  static constexpr int kBStride = BC + kVec;
  static constexpr int kAElems = AR * kAStride;
  static constexpr int kBElems = BR * kBStride;
  static constexpr int kBytes = STAGES * (kAElems + kBElems) * static_cast<int>(sizeof(T));
  static_assert(AC % kVec == 0 && BC % kVec == 0, "whole 16-byte chunks");
};

// ROWS x COLS elements at `g` (row stride ld) into `s` (row stride S):
// rows >= rows_valid and columns >= cols_valid read as zero.  `base` is a
// readable address for the chunks that read nothing.
template <typename T, int ROWS, int COLS, int S>
__device__ __forceinline__ void load_tile(T* s, const T* g, const T* base, int64_t ld,
                                          int rows_valid, int cols_valid, bool vec) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kChunks = ROWS * COLS / kVec;
  for (int c = threadIdx.x; c < kChunks; c += kThreads) {
    const int r = c / (COLS / kVec), cc = (c % (COLS / kVec)) * kVec;
    const int valid = r < rows_valid ? max(0, min(kVec, cols_valid - cc)) : 0;
    load_chunk<T>(s + r * S + cc, valid > 0 ? g + r * ld + cc : base, valid, vec);
  }
}

// bf16 on the tensor cores: WM x WN warps, each a (BM/WM) x (BN/WN) tile of
// m16n8 f32 accumulators.  A_KMAJ: A is staged [k][m] (tokens^T), read by
// ldmatrix.trans, else [m][k], by ldmatrix.  B_NMAJ: B is staged [n][k]
// (weights^T), read by ldmatrix, else [k][n], by ldmatrix.trans.
template <int BM, int BN, int BK, int WM, int WN, bool A_KMAJ = false, bool B_NMAJ = false>
struct MmaBf16 {
  using T = __nv_bfloat16;
  static constexpr int kWarpM = BM / WM, kWarpN = BN / WN;
  static constexpr int MT = kWarpM / 16, NT = kWarpN / 8;
  static_assert(WM * WN * 32 == kThreads, "one warp per sub-tile");
  static_assert(kWarpM % 16 == 0 && NT % 2 == 0 && BK % 16 == 0, "mma shapes");
  float acc[MT][NT][4];
  int wm0, wn0, lane;

  __device__ __forceinline__ void init() {
    const int warp = threadIdx.x / 32;
    lane = threadIdx.x % 32;
    wm0 = (warp / WN) * kWarpM;
    wn0 = (warp % WN) * kWarpN;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
  }

  template <int AS, int BS>
  __device__ __forceinline__ void compute(const T* sa, const T* sb) {
    // the 8 x 8 matrix a lane addresses a row of, and that row
    const int q = lane >> 3, r8 = lane & 7;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if constexpr (A_KMAJ)  // matrices (m, k): (0,0) (8,0) (0,8) (8,8)
          ldmatrix_x4_trans(af[i], sa + (kk + r8 + (q >> 1) * 8) * AS + wm0 + i * 16 + (q & 1) * 8);
        else
          ldmatrix_x4(af[i], sa + (wm0 + i * 16 + (lane & 15)) * AS + kk + (lane >> 4) * 8);
      }
      uint32_t bf[NT][2];
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t r[4];
        if constexpr (B_NMAJ)  // matrices (n, k): (0,0) (0,8) (8,0) (8,8)
          ldmatrix_x4(r, sb + (wn0 + jp * 16 + r8 + (q >> 1) * 8) * BS + kk + (q & 1) * 8);
        else
          ldmatrix_x4_trans(r, sb + (kk + (lane & 15)) * BS + wn0 + jp * 16 + (lane >> 4) * 8);
        bf[2 * jp][0] = r[0];
        bf[2 * jp][1] = r[1];
        bf[2 * jp + 1][0] = r[2];
        bf[2 * jp + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
  }

  // The tile at (m0, n0) into out (rows x cols, row stride cols).
  __device__ __forceinline__ void store(T* out, int64_t m0, int n0, int64_t rows, int cols) const {
    const int g = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = n0 + wn0 + j * 8 + tq * 2;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int64_t row = m0 + wm0 + i * 16 + g + h * 8;
          if (row >= rows) continue;
          if (col < cols) store_bf16(out + row * cols + col, acc[i][j][2 * h]);
          if (col + 1 < cols) store_bf16(out + row * cols + col + 1, acc[i][j][2 * h + 1]);
        }
      }
  }
};

// f32 on the SIMT cores: 16 x 8 threads, each BM/8 rows (8 apart) x 4
// neighbouring columns of a BM x 64 tile; the staging flags as above.
template <int BM, int BN, int BK, bool A_KMAJ = false, bool B_NMAJ = false>
struct SimtF32 {
  using T = float;
  static constexpr int TM = BM / 8;
  static_assert(BN == 64 && BM % 8 == 0, "16 x 8 threads over a BM x 64 tile");
  float acc[TM][4];
  int tx, ty;

  __device__ __forceinline__ void init() {
    tx = threadIdx.x % 16;
    ty = threadIdx.x / 16;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  template <int AS, int BS>
  __device__ __forceinline__ void compute(const T* sa, const T* sb) {
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      float b[4];
      if constexpr (B_NMAJ) {
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = sb[(tx * 4 + j) * BS + k];
      } else {  // 4 neighbours of a 16-byte aligned row: one vector read
        const float4 v = *reinterpret_cast<const float4*>(sb + k * BS + tx * 4);
        b[0] = v.x;
        b[1] = v.y;
        b[2] = v.z;
        b[3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int m = ty + 8 * i;
        const float av = A_KMAJ ? sa[k * AS + m] : sa[m * AS + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
      }
    }
  }

  __device__ __forceinline__ void store(T* out, int64_t m0, int n0, int64_t rows, int cols) const {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int64_t row = m0 + ty + 8 * i;
      if (row >= rows) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + tx * 4 + j;
        if (col < cols) out[row * cols + col] = acc[i][j];
      }
    }
  }
};

}  // namespace
