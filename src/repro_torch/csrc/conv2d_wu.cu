// K2 on Hopper: the weight-gradient ("update pass") convolution, §II-J.
//
// Replaces the Pallas kernel repro/kernels/conv2d_wu.py:conv2d_wu
// (_kernel_tiled).  Same function: from x (N,H,W,C) NHWC and dO (N,P,Q,K)
// NPQK,
//   dW[r,s,c,k] = sum over (n,p,q) of x[n, p*st+r-pad, q*st+s-pad, c] * dO[n,p,q,k]
// -> dW (R,S,C,K) RSCK, f32 accumulation.  Built with nvcc for sm_90a and
// bound through the plain C function at the bottom (ctypes; see
// repro_torch/kernels/_build.py).
//
// What bounds it: 2*N*P*Q*K*C*R*S FLOPs against reading x and dO once and
// writing dW once.  At ResNet-50's batch-32 shapes every weight gradient
// but the 56x56 1x1 64->64 one lies above the f32 ridge of 67 TFLOP/s over
// 3.35 TB/s, so the bound is the SIMT cores' f32 FMA rate.
//
// Why it does not follow the TPU kernel: that kernel keeps one
// (R,S,C_blk,K_blk) tile in VMEM across a sequential (n, p, q) grid sweep.
// On the card blocks run in parallel and nothing carries between them, and
// the dW tile is small against a long reduction (the 56x56 1x1 64->64 conv
// has 4,096 outputs and 100,352 pixels to sum), so one block per output tile
// would leave most of the 132 SMs idle.  The design:
//   * Per (r, s) a GEMM with M = C, N = K, reduced over the N*P*Q pixels.  A
//     block owns a BM x BN (C x K) tile of one (r, s) and one chunk of the
//     pixels.  Each reduction step stages 8 pixels of x (the input position
//     p*st+r-pad, q*st+s-pad, read along C) and of dO (read along K) in
//     shared memory, double buffered through registers, both loads
//     coalesced along the output's dimensions.  The zero halo and every
//     ragged P, Q, C and K edge come from load masks: no padded copy.
//   * Each thread keeps a TM x TN register tile of dW (the paper's register
//     blocking), f32 FMA on the SIMT cores.  TF32 or bf16 tensor cores would
//     break the f32 parity the reference holds; they are later work.
//   * Split-K over pixels, the §II-J "private copies" strategy mapped onto
//     blocks: each of `splits` chunks writes an f32 partial tile into a
//     scratch (splits, R, S, C, K); a second kernel sums the partials in a
//     fixed order.  Deterministic run to run, no atomics.  With splits == 1
//     the first kernel writes dW itself and the second does not run.  The
//     wrapper chooses splits from the shape (about two blocks per SM, at
//     most 4,096 pixels summed by one thread).
// Pixel indices are 32-bit (the wrapper checks N*P*Q < 2^31); offsets into
// x, dO and the scratch are 64-bit.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 8;  // pixels per reduction step

struct WuArgs {
  const float* x;
  const float* dout;
  float* out;  // (splits, R, S, C, K) partials, or dW itself when splits == 1
  int n, h, wd, c, k, r, s, stride, pad, p, q;
  int m;      // N*P*Q
  int chunk;  // pixels per split
};

template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
conv2d_wu_kernel(const WuArgs a) {
  static_assert((BM / TM) * (BN / TN) == kThreads, "one register tile per thread");
  static_assert(TM % 4 == 0 && TN % 4 == 0, "register tiles are float4 groups");
  static_assert(kThreads % BM == 0 && kThreads % BN == 0, "fixed channel per thread");
  constexpr int kAPer = BM * kPix / kThreads;  // x values a thread stages per step
  constexpr int kBPer = BN * kPix / kThreads;  // dO values a thread stages per step
  constexpr int kARows = kThreads / BM;        // pixel distance between a thread's x slots
  constexpr int kBRows = kThreads / BN;
  constexpr int kTX = BN / TN;                 // threads along K
  constexpr int kMGroup = BM * 4 / TM;         // row distance between a thread's float4 groups
  constexpr int kNGroup = BN * 4 / TN;
  __shared__ __align__(16) float As[2][kPix][BM];
  __shared__ __align__(16) float Bs[2][kPix][BN];

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int c0 = blockIdx.x * BM;
  const int k0 = blockIdx.y * BN;
  const int rs_count = a.r * a.s;
  const int rs = blockIdx.z % rs_count;
  const int split = blockIdx.z / rs_count;
  const int rr = rs / a.s;
  const int ss = rs % a.s;
  const int m_begin = split * a.chunk;
  const int m_end = min(m_begin + a.chunk, a.m);

  // This thread stages channel a_c of the pixels m_begin + tid/BM + i*kARows
  // (advanced by kPix each step; (n, p, q) follow incrementally) and output
  // channel b_k of the pixels m_begin + tid/BN + j*kBRows.
  const int a_c = c0 + tid % BM;
  const bool a_c_ok = a_c < a.c;
  int a_m[kAPer], a_n[kAPer], a_p[kAPer], a_q[kAPer];
#pragma unroll
  for (int i = 0; i < kAPer; ++i) {
    const int m = m_begin + tid / BM + i * kARows;
    a_m[i] = m;
    a_q[i] = m % a.q;
    a_p[i] = (m / a.q) % a.p;
    a_n[i] = m / a.q / a.p;
  }
  const int b_k = k0 + tid % BN;
  const bool b_k_ok = b_k < a.k;
  int b_m = m_begin + tid / BN;

  float a_reg[kAPer];
  float b_reg[kBPer];

  auto load = [&]() {
#pragma unroll
    for (int i = 0; i < kAPer; ++i) {
      const int ih = a_p[i] * a.stride + rr - a.pad;
      const int iw = a_q[i] * a.stride + ss - a.pad;
      const bool ok = a_c_ok && a_m[i] < m_end &&
                      static_cast<unsigned>(ih) < static_cast<unsigned>(a.h) &&
                      static_cast<unsigned>(iw) < static_cast<unsigned>(a.wd);
      a_reg[i] = ok ? __ldg(a.x + (static_cast<int64_t>(a_n[i] * a.h + ih) * a.wd + iw) * a.c + a_c)
                    : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kBPer; ++j) {
      const int m = b_m + j * kBRows;
      b_reg[j] = (b_k_ok && m < m_end) ? __ldg(a.dout + static_cast<int64_t>(m) * a.k + b_k) : 0.f;
    }
  };

  auto advance = [&]() {  // every slot moves kPix pixels on
#pragma unroll
    for (int i = 0; i < kAPer; ++i) {
      a_m[i] += kPix;
      a_q[i] += kPix;
      while (a_q[i] >= a.q) {
        a_q[i] -= a.q;
        if (++a_p[i] == a.p) {
          a_p[i] = 0;
          ++a_n[i];
        }
      }
    }
    b_m += kPix;
  };

  auto stage = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kAPer; ++i) As[buf][tid / BM + i * kARows][tid % BM] = a_reg[i];
#pragma unroll
    for (int j = 0; j < kBPer; ++j) Bs[buf][tid / BN + j * kBRows][tid % BN] = b_reg[j];
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int steps = m_end > m_begin ? (m_end - m_begin + kPix - 1) / kPix : 0;
  load();
  stage(0);
  __syncthreads();

  for (int t = 0; t < steps; ++t) {
    const int buf = t & 1;
    const bool more = t + 1 < steps;
    if (more) {
      advance();
      load();
    }
#pragma unroll
    for (int kc = 0; kc < kPix; ++kc) {
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

  // blockIdx.z = split * R*S + rs: the tile lands at out[split][r][s][c][k]
  float* out = a.out + static_cast<int64_t>(blockIdx.z) * a.c * a.k;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int cc = c0 + (i / 4) * kMGroup + ty * 4 + (i % 4);
    if (cc >= a.c) continue;
#pragma unroll
    for (int g = 0; g < TN / 4; ++g) {
      const int kk = k0 + g * kNGroup + tx * 4;
      if (kk >= a.k) continue;
      const int64_t off = static_cast<int64_t>(cc) * a.k + kk;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (kk + u < a.k) out[off + u] = acc[i][g * 4 + u];
    }
  }
}

// dW[i] = sum over splits, in split order, of part[split][i]: the second pass.
__global__ void __launch_bounds__(kThreads)
wu_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw, int64_t len, int splits) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < len;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float sum = part[i];
    for (int sp = 1; sp < splits; ++sp) sum += part[sp * len + i];
    dw[i] = sum;
  }
}

template <int BM, int BN, int TM, int TN>
void launch(const WuArgs& a, int splits, cudaStream_t stream) {
  const dim3 grid((a.c + BM - 1) / BM, (a.k + BN - 1) / BN, splits * a.r * a.s);
  conv2d_wu_kernel<BM, BN, TM, TN><<<grid, kThreads, 0, stream>>>(a);
}

}  // namespace

// Launches K2 on `stream` without synchronising: the split kernel, then
// (when splits > 1) the reduction of `partial` (splits, R, S, C, K) into dw.
// `tile` selects the C x K block tile: 0 = 128x128, 1 = 128x64, 2 = 64x64.
// Returns the first nonzero cudaGetLastError(), or cudaErrorInvalidValue for
// arguments it does not take.  The caller checks shapes, dtypes and
// contiguity, and chooses tile, splits and chunk (kernels/conv2d_wu.py).
extern "C" int repro_conv2d_wu_f32(const float* x, const float* dout, float* partial, float* dw,
                                   int n, int h, int wd, int c, int k, int r, int s, int stride,
                                   int pad, int tile, int splits, int chunk, void* stream) {
  WuArgs a;
  a.x = x;
  a.dout = dout;
  a.out = splits == 1 ? dw : partial;
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
  const int64_t m = static_cast<int64_t>(n) * a.p * a.q;
  if (m <= 0 || m > INT32_MAX || c <= 0 || k <= 0 || splits < 1 || chunk < 1 ||
      static_cast<int64_t>(splits) * chunk < m || static_cast<int64_t>(splits) * r * s > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  a.m = static_cast<int>(m);
  a.chunk = chunk;

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 0: launch<128, 128, 8, 8>(a, splits, st); break;
    case 1: launch<128, 64, 8, 4>(a, splits, st); break;
    case 2: launch<64, 64, 4, 4>(a, splits, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || splits == 1) return err;

  const int64_t len = static_cast<int64_t>(r) * s * c * k;
  const int64_t blocks = (len + kThreads - 1) / kThreads;
  const unsigned grid = static_cast<unsigned>(blocks < 4096 ? blocks : 4096);
  wu_reduce_kernel<<<grid, kThreads, 0, st>>>(partial, dw, len, splits);
  return static_cast<int>(cudaGetLastError());
}
