// The int8 tensor-core product and the dequantizing epilogue shared by the
// int8 convolutions: K3's tiled forward (conv2d_q8.cu) and K10c's whole-plane
// forward's mma route (conv2d_q8_whole.cu).
//
// mma.sync.m16n8k32.s32.s8.s8.s32 multiplies exactly and sums in int32;
// int32 sums are associative, so a kernel's tile and order change no bit.
// The epilogue rounds one int32 sum as the plain versions do: __int2float_rn,
// then __fmul_rn by deq (= x_scale * w_scale[k], one f32 multiply), then
// non-contracting scale, shift, bias, residual and relu, the reference's
// order.
//
// Everything here lives in an anonymous namespace: each source that
// includes it is its own library.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {
namespace q8 {

// d += a (16 x 32, row) x b (32 x 8, col), int8 operands, int32 sums: a[0..3]
// and b[0..1] are words of 4 consecutive k values.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One output value from its int32 sum: `a` names which of scale, shift, bias
// and residual are present and relu.
template <class Args>
__device__ __forceinline__ float dequant_epilogue(const Args& a, int acc, float dq, float sc,
                                                  float sh, float bi, float res) {
  float y = __int2float_rn(acc);
  y = __fmul_rn(y, dq);
  if (a.scale) y = __fmul_rn(y, sc);
  if (a.shift) y = __fadd_rn(y, sh);
  if (a.bias) y = __fadd_rn(y, bi);
  if (a.residual) y = __fadd_rn(y, res);
  if (a.relu) y = fmaxf(y, 0.f);
  return y;
}

}  // namespace q8
}  // namespace
