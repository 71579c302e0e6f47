// K10a on Hopper: direct convolution forward with the fused §II-G epilogue,
// by the reference's legacy whole-plane strategy.
//
// Replaces the Pallas kernel repro/kernels/conv2d_direct.py:_conv2d_whole_plane
// (_kernel_whole).  Same function as K1 (csrc/conv2d_direct.cu): xp, the
// padded plane (N,HP,WP,C) that the wrapper makes with pad_input, w (R,S,C,K)
// -> out (N,P,Q,K), f32 accumulation, then scale, shift, bias, residual, relu
// in that order.  Built with nvcc for sm_90a and bound through the plain C
// function at the bottom (ctypes; see repro_torch/kernels/_build.py).
//
// The strategy, in Hopper terms:
//   * The grid is the reference's (N, K_b, P_b): one block computes one
//     output block, an image, k_blk output channels and rb_p rows by the
//     full row Q, and runs over all of C itself.  No C split across blocks,
//     no order freedom.
//   * "Resident" means resident in L2: the padded plane of one image at
//     ResNet-50's lane-aligned layers is at most 3.4 MB against 50 MB of L2,
//     far above a block's 227 KB of shared memory.  So each pass stages the
//     (rows-1)*stride + r padded input rows it reads, by the full padded
//     width, in slices of 8 channels, and the matching (R, S, 8, BN) weight
//     slice, double buffered by cp.async.  The wrapper's padding covers the
//     halo and the ceil-div tail: no bounds test in any load.
//   * Each thread keeps a TM-pixel x 8-channel register tile.  When the
//     block's rb_p x Q pixels exceed the threads' tiles (a q8-sized rb_p),
//     the block makes several passes of rows_pass rows, each over all of C.
//   * Rows of the last block past P (rb_p need not divide P) are computed
//     from the padded plane's slack and not stored.
//   * The epilogue uses non-contracting multiplies and adds, so its rounding
//     follows the reference's order exactly.
// Offsets into xp, out and residual are 64-bit.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 8;  // input channels per staged slice
constexpr int kTN = 8;  // output channels per thread

struct WholeArgs {
  const float* xp;        // padded plane (N, HP, WP, C)
  const float* w;         // (R, S, C, K)
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

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int BN, int TM>
__global__ void __launch_bounds__(kThreads)
conv2d_direct_whole_kernel(const WholeArgs a) {
  constexpr int kTX = BN / kTN;       // threads along K
  constexpr int kTY = kThreads / kTX; // threads along pixels
  extern __shared__ __align__(16) float smem[];
  const int band_floats = ((a.rows_pass - 1) * a.stride + a.r) * a.wp * kBK;
  const int w_floats = a.r * a.s * kBK * BN;
  float* band[2] = {smem, smem + band_floats + w_floats};
  float* wts[2] = {smem + band_floats, smem + 2 * band_floats + w_floats};

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int nn = blockIdx.z;
  const int k0 = blockIdx.y * a.k_blk;
  const int p_begin = blockIdx.x * a.rb_p;
  const int p_end = min(p_begin + a.rb_p, a.p);
  const int slices = a.c / kBK;
  const int taps = a.r * a.s;
  const int w_chunks = taps * kBK * (BN / 4);
  const float* xn = a.xp + static_cast<int64_t>(nn) * a.hp * a.wp * a.c;

  for (int pp0 = p_begin; pp0 < p_end; pp0 += a.rows_pass) {
    const int rows = min(a.rows_pass, p_end - pp0);
    const int pixels = rows * a.q;
    const int band_chunks = ((rows - 1) * a.stride + a.r) * a.wp * (kBK / 4);
    // the pass's first padded row; band pixel j*WP + col is plane row
    // pp0*stride + j, column col, whose channels lie C floats apart
    const float* xrow = xn + static_cast<int64_t>(pp0) * a.stride * a.wp * a.c;

    int off[TM];  // this thread's output pixels, as band offsets of tap (0, 0)
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = ty + i * kTY;
      const int pl = m / a.q;
      const int qq = m - pl * a.q;
      off[i] = m < pixels ? (pl * a.stride * a.wp + qq * a.stride) * kBK : 0;
    }

    auto fetch = [&](int slice, int buf) {
      const int c0 = slice * kBK;
      for (int idx = tid; idx < band_chunks; idx += kThreads)
        cp_async16(band[buf] + idx * 4, xrow + static_cast<int64_t>(idx >> 1) * a.c + c0 + (idx & 1) * 4,
                   16);
      for (int idx = tid; idx < w_chunks; idx += kThreads) {
        const int kk = (idx % (BN / 4)) * 4;
        const int row = idx / (BN / 4);  // tap * kBK + channel
        const int tap = row / kBK;
        const bool ok = kk < a.k_blk;
        const float* src =
            ok ? a.w + static_cast<int64_t>(tap * a.c + c0 + row % kBK) * a.k + k0 + kk : a.w;
        cp_async16(wts[buf] + row * BN + kk, src, ok ? 16 : 0);
      }
    };

    float acc[TM][kTN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

    fetch(0, 0);
    cp_async_commit();
    for (int t = 0; t < slices; ++t) {
      const int buf = t & 1;
      if (t + 1 < slices) {
        fetch(t + 1, buf ^ 1);
        cp_async_commit();
        cp_async_wait<1>();  // slice t has landed
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* B = band[buf];
      const float* W = wts[buf] + tx * kTN;
      for (int rr = 0; rr < a.r; ++rr) {
        for (int ss = 0; ss < a.s; ++ss) {
          const int toff = (rr * a.wp + ss) * kBK;
          const float* Wt = W + (rr * a.s + ss) * kBK * BN;
#pragma unroll
          for (int kc = 0; kc < kBK; ++kc) {
            float af[TM];
#pragma unroll
            for (int i = 0; i < TM; ++i) af[i] = B[off[i] + toff + kc];
            const float4 b0 = *reinterpret_cast<const float4*>(Wt + kc * BN);
            const float4 b1 = *reinterpret_cast<const float4*>(Wt + kc * BN + 4);
            const float bf[kTN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
              for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(af[i], bf[j], acc[i][j]);
          }
        }
      }
      __syncthreads();  // every thread is done with buf before it refills
    }

    // Fused epilogue (reference order: scale, shift, bias, residual, relu).
    if (tx * kTN >= a.k_blk) continue;
    const int kk0 = k0 + tx * kTN;
    float sc[kTN], sh[kTN], bi[kTN];
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
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
          float y = acc[i][j];
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
int launch(const WholeArgs& a, int smem, cudaStream_t stream) {
  static int granted = 0;  // dynamic shared memory this instance may take
  if (smem > granted) {
    const cudaError_t e = cudaFuncSetAttribute(conv2d_direct_whole_kernel<BN, TM>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    granted = smem;
  }
  const dim3 grid((a.p + a.rb_p - 1) / a.rb_p, a.k / a.k_blk, a.n);
  conv2d_direct_whole_kernel<BN, TM><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_tm(const WholeArgs& a, int tm, int smem, cudaStream_t stream) {
  switch (tm) {
    case 4: return launch<BN, 4>(a, smem, stream);
    case 8: return launch<BN, 8>(a, smem, stream);
    case 12: return launch<BN, 12>(a, smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches K10a on `stream` without synchronising and returns
// cudaGetLastError(): nonzero means the launch was refused or an earlier
// fault is pending.  The caller pads the plane (pad_input), checks shapes,
// dtypes, contiguity and 16-byte alignment, and plans bn, tm, rows_pass and
// the shared memory (kernels/conv2d_direct.whole_plan).
extern "C" int repro_conv2d_direct_whole_f32(const float* xp, const float* w, const float* scale,
                                             const float* shift, const float* bias,
                                             const float* residual, float* out, int n, int hp,
                                             int wp, int c, int k, int r, int s, int stride, int p,
                                             int q, int rb_p, int k_blk, int rows_pass, int bn,
                                             int tm, int smem, int relu, void* stream) {
  WholeArgs a;
  a.xp = xp;
  a.w = w;
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
  if (n <= 0 || p <= 0 || q <= 0 || c % kBK || k_blk % kTN || k_blk > bn || k % k_blk ||
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
