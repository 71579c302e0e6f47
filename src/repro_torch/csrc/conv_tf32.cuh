// The 3xTF32 products mainloop shared by the convolutions' mma routes: K2's
// weight gradient (conv2d_wu.cu), K1's tiled forward (conv2d_direct.cu),
// K10a's whole-plane forward (conv2d_direct_whole.cu) and K4's stream
// replay (conv2d_streams.cu); and the fused epilogue of K1's and K10a's
// forwards.
//
// f32 products on the tensor cores without losing f32 parity: one-pass TF32
// keeps 11 bits of each operand; the split v = hi + lo, hi = tf32(v), lo =
// tf32(v - hi), keeps about 22, and lo*hi + hi*lo + hi*hi (lo*lo lies below
// f32's last bit) by mma.sync m16n8k8 tf32 with f32 sums holds the kernels'
// limit of 1e-5 of max |out|.  The tensor cores' adder may round toward
// zero, so a long run of mma sums drifts: each stage's products add up in a
// zeroed run accumulator that then joins the caller's f32 sums on the SIMT
// cores (round to nearest), so no tensor-core run holds more than 12
// products (4 k-steps of 8 x 3 mma).
//
// Everything here lives in an anonymous namespace: each source that
// includes it is its own library.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {
namespace tc {

constexpr int kStageK = 32;  // reduction depth of one stage_products call

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; zero-filled when src_bytes is 0.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// v = hi + lo + (below f32's 24th bit): hi = tf32(v), lo = tf32(v - hi),
// both rounded to nearest, ties away from zero.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v));
  const float rest = v - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// d += a (16 x 8, row) x b (8 x 8, col), TF32 operands, f32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One stage of a warp's MT x NT m16n8 tiles, reduced over KS input
// channels (kStageK unless a caller stages fewer: 8 or 16): acc[i][j] +=
// the 3xTF32 products of the stage, summed in a zeroed run accumulator
// first.
//   a[i][h]: the staged row of KS channels of output pixel g + 8h of the
//            warp's m16 tile i (g = lane / 4), channels contiguous;
//   b:       the stage's KS x N weight rows (row stride b_stride floats),
//            offset to this warp's first column plus g.
// Fragment reads are conflict-free when a pixel row's stride is an odd
// multiple of 4 (mod 32) floats and b_stride is 8 (mod 32).
template <int MT, int NT, int KS = kStageK>
__device__ __forceinline__ void stage_products(float (&acc)[MT][NT][4],
                                               const float* const (&a)[MT][2], const float* b,
                                               int b_stride) {
  static_assert(KS % 8 == 0 && KS <= kStageK, "whole k-steps, at most 12 products a run");
  const int tig = (threadIdx.x % 32) % 4;
  float run[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) run[i][j][c] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; kk += 8) {
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      split_tf32(a[i][0][kk + tig], ah[i][0], al[i][0]);      // (g, tig)
      split_tf32(a[i][1][kk + tig], ah[i][1], al[i][1]);      // (g + 8, tig)
      split_tf32(a[i][0][kk + tig + 4], ah[i][2], al[i][2]);  // (g, tig + 4)
      split_tf32(a[i][1][kk + tig + 4], ah[i][3], al[i][3]);  // (g + 8, tig + 4)
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* col = b + (kk + tig) * b_stride + j * 8;
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(col[0], bh0, bl0);                 // (tig, g)
      split_tf32(col[4 * b_stride], bh1, bl1);      // (tig + 4, g)
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        mma_tf32(run[i][j], al[i], bh0, bh1);
        mma_tf32(run[i][j], ah[i], bl0, bl1);
        mma_tf32(run[i][j], ah[i], bh0, bh1);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] += run[i][j][c];
}

// The fused epilogue of K1's and K10a's mma routes, on one f32 sum:
// relu?(((y * scale + shift) + bias) + residual), with non-contracting
// multiplies and adds so its rounding follows the reference's order.  `a`
// names which of scale, shift, bias and residual are present and relu.
template <class Args>
__device__ __forceinline__ float epilogue(const Args& a, float y, float sc, float sh, float bi,
                                          float res) {
  if (a.scale) y = __fmul_rn(y, sc);
  if (a.shift) y = __fadd_rn(y, sh);
  if (a.bias) y = __fadd_rn(y, bi);
  if (a.residual) y = __fadd_rn(y, res);
  if (a.relu) y = fmaxf(y, 0.f);
  return y;
}

}  // namespace tc
}  // namespace
