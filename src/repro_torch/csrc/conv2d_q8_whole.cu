// K10c on Hopper: int8 x int8 -> int32 direct convolution forward, dequantized
// in an f32 epilogue with the fused §II-G chain, by the reference's legacy
// whole-plane strategy.
//
// Replaces the Pallas kernel repro/kernels/conv2d_q8.py:_conv2d_q8_whole_plane
// (_kernel_q8_whole).  Same function as K3 (csrc/conv2d_q8.cu): xp, the padded
// int8 plane (N,HP,WP,C) that the wrapper makes with pad_input, and the int8
// weights, which the wrapper lays out as words of 4 input channels of one
// output channel, (R, S, C/4, K) -> out (N,P,Q,K) f32 =
//   relu?(((f32(acc) * deq) * scale + shift) + bias + residual),
// acc the exact int32 sum and deq = x_scale * w_scale[k] (one f32 multiply).
// Built with nvcc for sm_90a and bound through the plain C function at the
// bottom (ctypes; see repro_torch/kernels/_build.py).
//
// The strategy is K10a's (csrc/conv2d_direct_whole.cu): the grid is the
// reference's (N, K_b, P_b), one block computes one output block (an image,
// k_blk channels, rb_p rows by the full row Q) over all of C, the plane stays
// in L2 and each pass stages the padded rows it reads in slices of 32
// channels, double buffered by cp.async, with no bounds test in any load
// (the C tail of a slice is zero-filled).  The reference's int8 blocking grows
// rb_p to its budget, up to the whole plane, so a block makes as many passes
// of rows_pass rows as its pixels need.
//   * Products: __dp4a, four int8 products summed into int32 per instruction.
//     int32 sums are associative and R*S*C*127^2 < 2^31 (checked by the
//     wrapper), so the accumulator equals K3's whatever the order.
//   * Epilogue: K3's exactly: __int2float_rn, then __fmul_rn by deq, then
//     non-contracting scale, shift, bias, residual, relu.  So the output
//     equals K3's, and the plain version's, bit for bit: the reference's
//     contract between its tiled and whole-plane kernels.
// Offsets into xp, out and residual are 64-bit.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 32;          // input channels per staged slice
constexpr int kWords = kBK / 4;  // 32-bit words of 4 channels per pixel and slice
constexpr int kTN = 8;           // output channels per thread

struct Q8WholeArgs {
  const int8_t* xp;       // padded plane (N, HP, WP, C)
  const int* wt;          // (R, S, C/4, K) words of 4 input channels
  const float* x_scale;   // one f32
  const float* w_scale;   // (K,)
  const float* scale;     // may be null
  const float* shift;     // may be null
  const float* bias;      // may be null
  const float* residual;  // may be null, else (N,P,Q,K)
  float* out;
  int n, hp, wp, c, k, r, s, stride, p, q;
  int rb_p, k_blk, rows_pass, relu;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int BN, int TM>
__global__ void __launch_bounds__(kThreads)
conv2d_q8_whole_kernel(const Q8WholeArgs a) {
  constexpr int kTX = BN / kTN;
  constexpr int kTY = kThreads / kTX;
  extern __shared__ __align__(16) int smem_words[];
  const int band_words = ((a.rows_pass - 1) * a.stride + a.r) * a.wp * kWords;
  const int w_words = a.r * a.s * kWords * BN;
  int* band[2] = {smem_words, smem_words + band_words + w_words};
  int* wts[2] = {smem_words + band_words, smem_words + 2 * band_words + w_words};

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int nn = blockIdx.z;
  const int k0 = blockIdx.y * a.k_blk;
  const int p_begin = blockIdx.x * a.rb_p;
  const int p_end = min(p_begin + a.rb_p, a.p);
  const int slices = (a.c + kBK - 1) / kBK;
  const int cw = a.c / 4;  // words per weight row
  const int taps = a.r * a.s;
  const int w_chunks = taps * kWords * (BN / 4);
  const int8_t* xn = a.xp + static_cast<int64_t>(nn) * a.hp * a.wp * a.c;

  for (int pp0 = p_begin; pp0 < p_end; pp0 += a.rows_pass) {
    const int rows = min(a.rows_pass, p_end - pp0);
    const int pixels = rows * a.q;
    const int band_chunks = ((rows - 1) * a.stride + a.r) * a.wp * (kBK / 8);
    const int8_t* xrow = xn + static_cast<int64_t>(pp0) * a.stride * a.wp * a.c;

    int off[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = ty + i * kTY;
      const int pl = m / a.q;
      const int qq = m - pl * a.q;
      off[i] = m < pixels ? (pl * a.stride * a.wp + qq * a.stride) * kWords : 0;
    }

    auto fetch = [&](int slice, int buf) {
      const int c0 = slice * kBK;
      for (int idx = tid; idx < band_chunks; idx += kThreads) {  // 8 channels each
        const int ch = c0 + (idx & 3) * 8;
        const bool ok = ch < a.c;
        const int8_t* src = ok ? xrow + static_cast<int64_t>(idx >> 2) * a.c + ch : a.xp;
        cp_async8(band[buf] + idx * 2, src, ok ? 8 : 0);
      }
      for (int idx = tid; idx < w_chunks; idx += kThreads) {  // 4 output channels each
        const int kk = (idx % (BN / 4)) * 4;
        const int row = idx / (BN / 4);  // tap * kWords + word
        const int tap = row / kWords;
        const int word = c0 / 4 + row % kWords;
        const bool ok = kk < a.k_blk && word < cw;
        const int* src = ok ? a.wt + static_cast<int64_t>(tap * cw + word) * a.k + k0 + kk : a.wt;
        cp_async16(wts[buf] + row * BN + kk, src, ok ? 16 : 0);
      }
    };

    int acc[TM][kTN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0;

    fetch(0, 0);
    cp_async_commit();
    for (int t = 0; t < slices; ++t) {
      const int buf = t & 1;
      if (t + 1 < slices) {
        fetch(t + 1, buf ^ 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int* B = band[buf];
      const int* W = wts[buf] + tx * kTN;
      for (int rr = 0; rr < a.r; ++rr) {
        for (int ss = 0; ss < a.s; ++ss) {
          const int toff = (rr * a.wp + ss) * kWords;
          const int* Wt = W + (rr * a.s + ss) * kWords * BN;
#pragma unroll
          for (int kw = 0; kw < kWords; ++kw) {
            int av[TM];
#pragma unroll
            for (int i = 0; i < TM; ++i) av[i] = B[off[i] + toff + kw];
            const int4 b0 = *reinterpret_cast<const int4*>(Wt + kw * BN);
            const int4 b1 = *reinterpret_cast<const int4*>(Wt + kw * BN + 4);
            const int bv[kTN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
              for (int j = 0; j < kTN; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
          }
        }
      }
      __syncthreads();
    }

    // Dequantize, then the fused epilogue (reference order: scale, shift,
    // bias, residual, relu), rounding exactly as K3 does.
    if (tx * kTN >= a.k_blk) continue;
    const int kk0 = k0 + tx * kTN;
    const float xs = *a.x_scale;
    float dq[kTN], sc[kTN], sh[kTN], bi[kTN];
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      dq[j] = __fmul_rn(xs, a.w_scale[kk0 + j]);
      sc[j] = a.scale ? a.scale[kk0 + j] : 1.f;
      sh[j] = a.shift ? a.shift[kk0 + j] : 0.f;
      bi[j] = a.bias ? a.bias[kk0 + j] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = ty + i * kTY;
      if (m >= pixels) continue;
      const int pl = m / a.q;
      const int qq = m - pl * a.q;
      const int64_t off_o = ((static_cast<int64_t>(nn) * a.p + pp0 + pl) * a.q + qq) * a.k + kk0;
#pragma unroll
      for (int g = 0; g < kTN / 4; ++g) {
        float res[4] = {0.f, 0.f, 0.f, 0.f};
        if (a.residual) {
          const float4 rv = *reinterpret_cast<const float4*>(a.residual + off_o + g * 4);
          res[0] = rv.x;
          res[1] = rv.y;
          res[2] = rv.z;
          res[3] = rv.w;
        }
        float v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = g * 4 + u;
          float y = __int2float_rn(acc[i][j]);
          y = __fmul_rn(y, dq[j]);
          if (a.scale) y = __fmul_rn(y, sc[j]);
          if (a.shift) y = __fadd_rn(y, sh[j]);
          if (a.bias) y = __fadd_rn(y, bi[j]);
          if (a.residual) y = __fadd_rn(y, res[u]);
          if (a.relu) y = fmaxf(y, 0.f);
          v[u] = y;
        }
        *reinterpret_cast<float4*>(a.out + off_o + g * 4) = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

template <int BN, int TM>
int launch(const Q8WholeArgs& a, int smem, cudaStream_t stream) {
  static int granted = 0;
  if (smem > granted) {
    const cudaError_t e = cudaFuncSetAttribute(conv2d_q8_whole_kernel<BN, TM>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    granted = smem;
  }
  const dim3 grid((a.p + a.rb_p - 1) / a.rb_p, a.k / a.k_blk, a.n);
  conv2d_q8_whole_kernel<BN, TM><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_tm(const Q8WholeArgs& a, int tm, int smem, cudaStream_t stream) {
  switch (tm) {
    case 4: return launch<BN, 4>(a, smem, stream);
    case 8: return launch<BN, 8>(a, smem, stream);
    case 12: return launch<BN, 12>(a, smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches K10c on `stream` without synchronising and returns
// cudaGetLastError(): nonzero means the launch was refused or an earlier
// fault is pending.  The caller pads the plane (pad_input), lays the weights
// out as (R, S, C/4, K) words, checks shapes, dtypes, contiguity, alignment
// and the int32 overflow bound, and plans bn, tm, rows_pass and the shared
// memory (kernels/conv2d_direct.whole_plan).
extern "C" int repro_conv2d_q8_whole(const int8_t* xp, const int* wt, const float* x_scale,
                                     const float* w_scale, const float* scale,
                                     const float* shift, const float* bias,
                                     const float* residual, float* out, int n, int hp, int wp,
                                     int c, int k, int r, int s, int stride, int p, int q,
                                     int rb_p, int k_blk, int rows_pass, int bn, int tm,
                                     int smem, int relu, void* stream) {
  Q8WholeArgs a;
  a.xp = xp;
  a.wt = wt;
  a.x_scale = x_scale;
  a.w_scale = w_scale;
  a.scale = scale;
  a.shift = shift;
  a.bias = bias;
  a.residual = residual;
  a.out = out;
  a.n = n;
  a.hp = hp;
  a.wp = wp;
  a.c = c;
  a.k = k;
  a.r = r;
  a.s = s;
  a.stride = stride;
  a.p = p;
  a.q = q;
  a.rb_p = rb_p;
  a.k_blk = k_blk;
  a.rows_pass = rows_pass;
  a.relu = relu;
  if (n <= 0 || p <= 0 || q <= 0 || c % 8 || k_blk % kTN || k_blk > bn || k % k_blk ||
      rb_p <= 0 || rows_pass <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 32: return launch_tm<32>(a, tm, smem, st);
    case 64: return launch_tm<64>(a, tm, smem, st);
    case 128: return launch_tm<128>(a, tm, smem, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
