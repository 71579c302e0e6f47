// K1 on Hopper: direct convolution forward with the fused §II-G epilogue.
//
// Replaces the Pallas kernel repro/kernels/conv2d_direct.py:conv2d_direct
// (_kernel_tiled).  Same function: x (N,H,W,C) NHWC, w (R,S,C,K) RSCK ->
// out (N,P,Q,K), f32 accumulation, then scale, shift, bias, residual, relu
// in that order.  Built with nvcc for sm_90a and bound through the plain C
// function at the bottom (ctypes; see repro_torch/kernels/_build.py).
//
// Design: an implicit GEMM on the SIMT cores.  M = N*P*Q output pixels
// (flattened across images, so the 7x7 and 14x14 stages still give enough
// blocks), N_gemm = K output channels, reduced over (r, s, c).
//   * A block owns a BM x BN output tile.  Each reduction step stages the
//     input pixels of one (r, s) and 8 input channels (the im2col slice,
//     gathered straight from NHWC; the zero halo of `padding` and every
//     ragged P/Q/C/K edge come from the load masks, no padded copy) and the
//     matching 8 x BN weight slice in shared memory, double buffered
//     through registers so the next step's loads overlap this step's FMAs.
//   * Each thread keeps a TM x TN register tile of outputs: the paper's
//     RB_P x RB_Q register blocking (§II-B), here over flattened pixels.
//   * Accumulation is f32 FMA.  No tensor cores: TF32 would break the f32
//     parity the reference holds.
//   * The epilogue runs on the register tile before the single store, with
//     non-contracting multiplies and adds so its rounding follows the
//     reference's order exactly.
// Offsets into x, out and residual are 64-bit: a bucket of 16 at 112x112x64
// already has 12.8 M elements per tensor.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 8;  // input channels per reduction step

struct ConvArgs {
  const float* x;
  const float* w;
  const float* scale;     // may be null
  const float* shift;     // may be null
  const float* bias;      // may be null
  const float* residual;  // may be null, else (N,P,Q,K)
  float* out;
  int n, h, wd, c, k, r, s, stride, pad, p, q;
  int64_t m;  // N*P*Q
  int relu;
  int vec4;  // K % 4 == 0 and out/residual 16-byte aligned
};

template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
conv2d_direct_kernel(const ConvArgs a) {
  static_assert((BM / TM) * (BN / TN) == kThreads, "one register tile per thread");
  static_assert(TM % 4 == 0 && TN % 4 == 0, "register tiles are float4 groups");
  constexpr int kAPer = BM * kBK / kThreads;  // input values a thread stages per step
  constexpr int kBPer = BN * kBK / kThreads;  // weight values a thread stages per step
  constexpr int kTX = BN / TN;                // threads along K
  constexpr int kMGroup = BM * 4 / TM;        // row distance between a thread's float4 groups
  constexpr int kNGroup = BN * 4 / TN;
  // +4 floats per row: the staging stores of 8 channels x 4 pixels per warp
  // then fall on 32 distinct banks, and rows stay 16-byte aligned.
  __shared__ __align__(16) float As[2][kBK][BM + 4];
  __shared__ __align__(16) float Bs[2][kBK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int k0 = blockIdx.y * BN;

  // This thread stages channel a_kc of the pixels tid/kBK + i*(kThreads/kBK).
  const int a_kc = tid % kBK;
  int a_ih0[kAPer], a_iw0[kAPer];
  int64_t a_base[kAPer];
#pragma unroll
  for (int i = 0; i < kAPer; ++i) {
    const int64_t m = m0 + tid / kBK + i * (kThreads / kBK);
    if (m < a.m) {
      const int qq = static_cast<int>(m % a.q);
      const int64_t t = m / a.q;
      const int pp = static_cast<int>(t % a.p);
      const int64_t nn = t / a.p;
      a_ih0[i] = pp * a.stride - a.pad;
      a_iw0[i] = qq * a.stride - a.pad;
      a_base[i] = nn * a.h * a.wd * a.c;
    } else {  // past the last pixel: every load of it is masked to zero
      a_ih0[i] = INT_MIN / 2;
      a_iw0[i] = INT_MIN / 2;
      a_base[i] = 0;
    }
  }

  float a_reg[kAPer];
  float b_reg[kBPer];

  auto load = [&](int rr, int ss, int c0) {
    const int c = c0 + a_kc;
#pragma unroll
    for (int i = 0; i < kAPer; ++i) {
      const int ih = a_ih0[i] + rr;
      const int iw = a_iw0[i] + ss;
      const bool ok = c < a.c && static_cast<unsigned>(ih) < static_cast<unsigned>(a.h) &&
                      static_cast<unsigned>(iw) < static_cast<unsigned>(a.wd);
      a_reg[i] = ok ? __ldg(a.x + a_base[i] + (static_cast<int64_t>(ih) * a.wd + iw) * a.c + c)
                    : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kBPer; ++j) {
      const int idx = tid + j * kThreads;
      const int cc = c0 + idx / BN;
      const int kk = k0 + idx % BN;
      b_reg[j] = (cc < a.c && kk < a.k)
                     ? __ldg(a.w + (static_cast<int64_t>(rr * a.s + ss) * a.c + cc) * a.k + kk)
                     : 0.f;
    }
  };

  auto stage = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kAPer; ++i) As[buf][a_kc][tid / kBK + i * (kThreads / kBK)] = a_reg[i];
#pragma unroll
    for (int j = 0; j < kBPer; ++j) {
      const int idx = tid + j * kThreads;
      Bs[buf][idx / BN][idx % BN] = b_reg[j];
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int c_steps = (a.c + kBK - 1) / kBK;
  const int steps = a.r * a.s * c_steps;
  int rr = 0, ss = 0, c0 = 0;
  load(rr, ss, c0);
  stage(0);
  __syncthreads();

  for (int t = 0; t < steps; ++t) {
    const int buf = t & 1;
    const bool more = t + 1 < steps;
    if (more) {  // C innermost, then s, then r
      c0 += kBK;
      if (c0 >= a.c) {
        c0 = 0;
        if (++ss == a.s) {
          ss = 0;
          ++rr;
        }
      }
      load(rr, ss, c0);
    }
#pragma unroll
    for (int kc = 0; kc < kBK; ++kc) {
      float af[TM], bf[TN];
#pragma unroll
      for (int g = 0; g < TM / 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(&As[buf][kc][g * kMGroup + ty * 4]);
        af[g * 4 + 0] = v.x;
        af[g * 4 + 1] = v.y;
        af[g * 4 + 2] = v.z;
        af[g * 4 + 3] = v.w;
      }
#pragma unroll
      for (int g = 0; g < TN / 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(&Bs[buf][kc][g * kNGroup + tx * 4]);
        bf[g * 4 + 0] = v.x;
        bf[g * 4 + 1] = v.y;
        bf[g * 4 + 2] = v.z;
        bf[g * 4 + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(af[i], bf[j], acc[i][j]);
    }
    if (more) stage(buf ^ 1);
    __syncthreads();
  }

  // Fused epilogue (reference order: scale, shift, bias, residual, relu).
  float sc[TN], sh[TN], bi[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int kk = k0 + (j / 4) * kNGroup + tx * 4 + (j % 4);
    const bool in = kk < a.k;
    sc[j] = (in && a.scale) ? a.scale[kk] : 1.f;
    sh[j] = (in && a.shift) ? a.shift[kk] : 0.f;
    bi[j] = (in && a.bias) ? a.bias[kk] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t m = m0 + (i / 4) * kMGroup + ty * 4 + (i % 4);
    if (m >= a.m) continue;
#pragma unroll
    for (int g = 0; g < TN / 4; ++g) {
      const int kk = k0 + g * kNGroup + tx * 4;
      if (kk >= a.k) continue;
      const int64_t off = m * a.k + kk;
      float v[4], res[4] = {0.f, 0.f, 0.f, 0.f};
      if (a.residual) {
        if (a.vec4) {
          const float4 rv = *reinterpret_cast<const float4*>(a.residual + off);
          res[0] = rv.x;
          res[1] = rv.y;
          res[2] = rv.z;
          res[3] = rv.w;
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (kk + u < a.k) res[u] = a.residual[off + u];
        }
      }
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
      if (a.vec4) {
        *reinterpret_cast<float4*>(a.out + off) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (kk + u < a.k) a.out[off + u] = v[u];
      }
    }
  }
}

template <int BM, int BN, int TM, int TN>
void launch(const ConvArgs& a, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((a.m + BM - 1) / BM), (a.k + BN - 1) / BN);
  conv2d_direct_kernel<BM, BN, TM, TN><<<grid, kThreads, 0, stream>>>(a);
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }

}  // namespace

// Launches K1 on `stream` without synchronising and returns
// cudaGetLastError(): nonzero means the launch was refused or an earlier
// fault is pending.  The caller checks shapes, dtypes and contiguity.
extern "C" int repro_conv2d_direct_f32(const float* x, const float* w, const float* scale,
                                       const float* shift, const float* bias,
                                       const float* residual, float* out, int n, int h, int wd,
                                       int c, int k, int r, int s, int stride, int pad, int relu,
                                       void* stream) {
  ConvArgs a;
  a.x = x;
  a.w = w;
  a.scale = scale;
  a.shift = shift;
  a.bias = bias;
  a.residual = residual;
  a.out = out;
  a.n = n;
  a.h = h;
  a.wd = wd;
  a.c = c;
  a.k = k;
  a.r = r;
  a.s = s;
  a.stride = stride;
  a.pad = pad;
  a.p = (h + 2 * pad - r) / stride + 1;
  a.q = (wd + 2 * pad - s) / stride + 1;
  a.m = static_cast<int64_t>(n) * a.p * a.q;
  a.relu = relu;
  a.vec4 = (k % 4 == 0) && aligned16(out) && (residual == nullptr || aligned16(residual));
  if (a.m <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);

  // Largest tile that still gives every SM a block; the small late-stage
  // planes (7x7, 14x14) drop to narrower tiles instead of idling SMs.
  const int sms = sm_count();
  auto blocks = [&](int bm, int bn) { return ((a.m + bm - 1) / bm) * ((k + bn - 1) / bn); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k > 64 && blocks(128, 128) >= sms) {
    launch<128, 128, 8, 8>(a, st);
  } else if (blocks(128, 64) >= sms) {
    launch<128, 64, 8, 4>(a, st);
  } else {
    launch<64, 64, 4, 4>(a, st);
  }
  return static_cast<int>(cudaGetLastError());
}
