// K1 on Hopper: direct convolution forward with the fused §II-G epilogue.
//
// Replaces the Pallas kernel repro/kernels/conv2d_direct.py:conv2d_direct
// (_kernel_tiled).  Same function: x (N,H,W,C) NHWC, w (R,S,C,K) RSCK ->
// out (N,P,Q,K), f32 accumulation, then scale, shift, bias, residual, relu
// in that order.  Built with nvcc for sm_90a and bound through the plain C
// functions at the bottom (ctypes; see repro_torch/kernels/_build.py).
//
// Both routes are an implicit GEMM: M = N*P*Q output pixels (flattened
// across images, so the 7x7 and 14x14 stages still give blocks), N_gemm = K
// output channels, reduced over (r, s, c) with C innermost.  A block owns a
// BM x BN output tile and stages, per reduction step, the input pixels of one
// (r, s) and a slice of input channels (the im2col slice, gathered straight
// from NHWC; the zero halo of `padding` and every ragged P/Q/C/K edge come
// from load masks, no padded copy) with the matching weight slice.  The
// epilogue runs on the tile before the single store, with non-contracting
// multiplies and adds so its rounding follows the reference's order.
//
// What bounds it: at ResNet-50's shapes nearly every conv does more than 20
// FLOP per byte it must move, so operations: 67 TFLOP/s of f32 FMA on the
// SIMT cores, or three TF32 products per f32 one at 494.7 TFLOP/s on the
// tensor cores.  Two routes, chosen in the wrapper
// (kernels/conv2d_direct.route):
//
// conv2d_direct_kernel_mma, for C and K multiples of 4 and 16-byte aligned x
// and w (every lane-aligned conv and every dual sub-filter): the products on
// the tensor cores by the 3xTF32 split of conv_tf32.cuh, each 32-channel
// stage's products summed in a zeroed run accumulator that then joins the
// block's f32 sums, which holds the f32 parity one-pass TF32 would break.
//   * a ring of 3 or 4 stages of one (r, s) and 32 input channels, filled by
//     16-byte cp.async copies (zero-filled on the halo and the P, Q, C and K
//     tails); pixel rows are padded to 36 floats and weight rows by 8, so the
//     fragment loads are free of bank conflicts;
//   * the block tile (128x128, 128x64, 64x128, 64x64) and a split of the
//     (r, s, c) steps across blocks are planned by the wrapper
//     (conv2d_direct.mma_plan) to fill rounds of the card's block slots; with
//     a split, each block writes its f32 partial tile to a scratch and
//     direct_split_sum_kernel sums the partials in split order and then
//     applies the epilogue: the same bits on every run, no atomics.
//
// conv2d_direct_kernel, every other shape: f32 FMA on the SIMT cores, 8
// input channels a step, double buffered through registers; each thread
// keeps a TM x TN register tile of outputs, the paper's RB_P x RB_Q register
// blocking (§II-B) over flattened pixels.
// Offsets into x, out and residual are 64-bit: a bucket of 16 at 112x112x64
// already has 12.8 M elements per tensor.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "conv_tf32.cuh"

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

// ---- the mma route: 3xTF32 on the tensor cores ------------------------------

namespace tc {

constexpr int kAS = kStageK + 4;  // floats of a staged pixel row: conflict-free fragments
constexpr int kBPad = 8;          // floats past each staged weight row

// A BM x BN block of WM x WN warps, STAGES ring stages, MINB blocks an SM.
template <int BM, int BN, int WM, int WN, int STAGES, int MINB>
struct Cfg {
  static constexpr int kThreads = WM * WN * 32;
  static constexpr int kWTM = BM / WM, kWTN = BN / WN;  // a warp's tile
  static constexpr int MT = kWTM / 16, NT = kWTN / 8;   // its m16n8 tiles
  static constexpr int kBS = BN + kBPad;
  static constexpr int kStageFloats = BM * kAS + kStageK * kBS;
  static constexpr int kSmem = STAGES * kStageFloats * 4;
  static constexpr int kARows = kThreads / (kStageK / 4);  // pixel rows apart a thread's copies lie
  static constexpr int kACopies = BM / kARows;             // x copies a thread makes a stage
  static constexpr int kBRows = kThreads / (BN / 4);
  static constexpr int kBCopies = kStageK / kBRows;        // w copies
  static_assert(kWTM % 16 == 0 && kWTN % 8 == 0, "m16n8 tiles");
  static_assert(kACopies >= 1 && kBCopies >= 1 && BM % kARows == 0 && kStageK % kBRows == 0,
                "a fixed 4-channel group per thread");
};

// Reduction steps [blockIdx.z * chunk, + chunk) of the (r, s, c/32) sequence,
// C innermost.  partial == nullptr: the epilogue and the store to out; else
// the f32 tile goes to partial[blockIdx.z] (M x K).
template <int BM, int BN, int WM, int WN, int STAGES, int MINB>
__global__ void __launch_bounds__(WM * WN * 32, MINB)
conv2d_direct_kernel_mma(const ConvArgs a, float* partial, int chunk) {
  using G = Cfg<BM, BN, WM, WN, STAGES, MINB>;
  constexpr int MT = G::MT, NT = G::NT;
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int wm0 = (warp / WN) * G::kWTM, wn0 = (warp % WN) * G::kWTN;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int k0 = blockIdx.y * BN;
  const int c_steps = (a.c + kStageK - 1) / kStageK;
  const int t_begin = blockIdx.z * chunk;
  const int n_steps = min(chunk, a.r * a.s * c_steps - t_begin);

  // this thread copies channels a_cg*4 .. +3 of the stage's pixel rows
  // tid / 8 + i * kARows, and output channels b_col .. +3 of its weight rows
  // tid / (BN/4) + j * kBRows
  const int a_cg = tid % (kStageK / 4);
  int a_ih0[G::kACopies], a_iw0[G::kACopies];
  int64_t a_base[G::kACopies];
#pragma unroll
  for (int i = 0; i < G::kACopies; ++i) {
    const int64_t m = m0 + tid / (kStageK / 4) + i * G::kARows;
    if (m < a.m) {
      const int qq = static_cast<int>(m % a.q);
      const int64_t t = m / a.q;
      const int pp = static_cast<int>(t % a.p);
      a_ih0[i] = pp * a.stride - a.pad;
      a_iw0[i] = qq * a.stride - a.pad;
      a_base[i] = (t / a.p) * a.h * a.wd * a.c;
    } else {  // past the last pixel: every copy of it is zero-filled
      a_ih0[i] = INT_MIN / 2;
      a_iw0[i] = INT_MIN / 2;
      a_base[i] = 0;
    }
  }
  const int b_col = (tid % (BN / 4)) * 4;
  const bool b_ok = k0 + b_col < a.k;

  auto load = [&](int buf, int t) {
    const int rs = t / c_steps;
    const int c0 = (t - rs * c_steps) * kStageK;
    const int rr = rs / a.s, ss = rs % a.s;
    float* as = smem + buf * G::kStageFloats;
    float* bs = as + BM * kAS;
    const int c = c0 + a_cg * 4;
#pragma unroll
    for (int i = 0; i < G::kACopies; ++i) {
      const int row = tid / (kStageK / 4) + i * G::kARows;
      const int ih = a_ih0[i] + rr;
      const int iw = a_iw0[i] + ss;
      const bool ok = c < a.c && static_cast<unsigned>(ih) < static_cast<unsigned>(a.h) &&
                      static_cast<unsigned>(iw) < static_cast<unsigned>(a.wd);
      cp_async16(as + row * kAS + a_cg * 4,
                 ok ? a.x + a_base[i] + (static_cast<int64_t>(ih) * a.wd + iw) * a.c + c : a.x,
                 ok ? 16 : 0);
    }
#pragma unroll
    for (int j = 0; j < G::kBCopies; ++j) {
      const int row = tid / (BN / 4) + j * G::kBRows;
      const bool ok = b_ok && c0 + row < a.c;
      cp_async16(bs + row * G::kBS + b_col,
                 ok ? a.w + (static_cast<int64_t>(rs) * a.c + c0 + row) * a.k + k0 + b_col : a.w,
                 ok ? 16 : 0);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_steps) load(st, t_begin + st);
    cp_async_commit();
  }
  for (int t = 0; t < n_steps; ++t) {
    cp_async_wait<STAGES - 2>();  // stage t has landed
    __syncthreads();              // and every warp is done with stage t - 1
    const int nxt = t + STAGES - 1;
    if (nxt < n_steps) load(nxt % STAGES, t_begin + nxt);
    cp_async_commit();

    const float* as = smem + (t % STAGES) * G::kStageFloats;
    const float* arow[MT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) arow[i][h] = as + (wm0 + i * 16 + g + 8 * h) * kAS;
    stage_products<MT, NT>(acc, arow, as + BM * kAS + wn0 + g, G::kBS);
  }
  cp_async_wait<0>();

  // each (pixel, k..k+1) pair is one aligned float2: K % 4 == 0
  if (partial) {
    float* part = partial + static_cast<int64_t>(blockIdx.z) * a.m * a.k;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int kk = k0 + wn0 + j * 8 + 2 * tig;
      if (kk >= a.k) continue;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int64_t m = m0 + wm0 + i * 16 + g + 8 * h;
          if (m < a.m)
            *reinterpret_cast<float2*>(part + m * a.k + kk) =
                make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int kk = k0 + wn0 + j * 8 + 2 * tig;
    if (kk >= a.k) continue;
    float sc[2], sh[2], bi[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      sc[u] = a.scale ? a.scale[kk + u] : 1.f;
      sh[u] = a.shift ? a.shift[kk + u] : 0.f;
      bi[u] = a.bias ? a.bias[kk + u] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t m = m0 + wm0 + i * 16 + g + 8 * h;
        if (m >= a.m) continue;
        const int64_t off = m * a.k + kk;
        const float2 res =
            a.residual ? *reinterpret_cast<const float2*>(a.residual + off) : make_float2(0.f, 0.f);
        *reinterpret_cast<float2*>(a.out + off) =
            make_float2(epilogue(a, acc[i][j][2 * h], sc[0], sh[0], bi[0], res.x),
                        epilogue(a, acc[i][j][2 * h + 1], sc[1], sh[1], bi[1], res.y));
      }
  }
}

// The second pass of a split: out = epilogue(sum over splits, in split
// order, of partial[split]), four channels a thread.
__global__ void __launch_bounds__(256)
direct_split_sum_kernel(const ConvArgs a, const float* __restrict__ partial, int splits) {
  const int64_t len = a.m * a.k;
  for (int64_t i = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * 4; i < len;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x * 4) {
    float4 v = *reinterpret_cast<const float4*>(partial + i);
    for (int sp = 1; sp < splits; ++sp) {
      const float4 u = *reinterpret_cast<const float4*>(partial + sp * len + i);
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    const int kk = static_cast<int>(i % a.k);
    const float4 res = a.residual ? *reinterpret_cast<const float4*>(a.residual + i)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
    float y[4] = {v.x, v.y, v.z, v.w};
    const float r4[4] = {res.x, res.y, res.z, res.w};
#pragma unroll
    for (int u = 0; u < 4; ++u)
      y[u] = epilogue(a, y[u], a.scale ? a.scale[kk + u] : 1.f, a.shift ? a.shift[kk + u] : 0.f,
                      a.bias ? a.bias[kk + u] : 0.f, r4[u]);
    *reinterpret_cast<float4*>(a.out + i) = make_float4(y[0], y[1], y[2], y[3]);
  }
}

template <int BM, int BN, int WM, int WN, int STAGES, int MINB>
int launch(const ConvArgs& a, float* partial, int splits, int chunk, cudaStream_t stream) {
  using G = Cfg<BM, BN, WM, WN, STAGES, MINB>;
  auto kernel = conv2d_direct_kernel_mma<BM, BN, WM, WN, STAGES, MINB>;
  // per call: the attribute belongs to the current device
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((a.m + BM - 1) / BM), (a.k + BN - 1) / BN, splits);
  kernel<<<grid, G::kThreads, G::kSmem, stream>>>(a, splits > 1 ? partial : nullptr, chunk);
  int e = static_cast<int>(cudaGetLastError());
  if (e != 0 || splits == 1) return e;
  const int64_t groups = a.m * a.k / 4;
  const int64_t blocks = (groups + 255) / 256;
  direct_split_sum_kernel<<<static_cast<unsigned>(blocks < 8192 ? blocks : 8192), 256, 0,
                            stream>>>(a, partial, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

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

// The mma route (3xTF32 on the tensor cores), with the arguments of
// repro_conv2d_direct_f32 and: `partial`, a scratch of splits x N*P*Q x K
// floats (unused when splits == 1); `tile`, 0 = 128x128, 1 = 128x64, 2 =
// 64x128, 3 = 64x64 (pixels x output channels); `splits` blocks share each
// tile's R*S*ceil(C/32) reduction steps, `chunk` steps each, none empty
// (kernels/conv2d_direct.mma_plan).  C and K must be multiples of 4 and x,
// w, out, residual and partial 16-byte aligned (kernels/conv2d_direct.route).
// Returns cudaErrorInvalidValue for arguments off that rule, else the first
// nonzero CUDA error of the launches (the split's sum pass included).
extern "C" int repro_conv2d_direct_mma(const float* x, const float* w, const float* scale,
                                       const float* shift, const float* bias,
                                       const float* residual, float* out, float* partial, int n,
                                       int h, int wd, int c, int k, int r, int s, int stride,
                                       int pad, int relu, int tile, int splits, int chunk,
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
  a.vec4 = 1;
  const int64_t steps = static_cast<int64_t>(r) * s * ((c + tc::kStageK - 1) / tc::kStageK);
  if (a.m <= 0 || c <= 0 || k <= 0 || c % 4 || k % 4 || !aligned16(x) || !aligned16(w) ||
      !aligned16(out) || (residual && !aligned16(residual)) || splits < 1 || splits > 65535 ||
      chunk < 1 || static_cast<int64_t>(splits) * chunk < steps ||
      static_cast<int64_t>(splits - 1) * chunk >= steps || (splits > 1 && !aligned16(partial)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 0: return tc::launch<128, 128, 4, 2, 4, 1>(a, partial, splits, chunk, st);
    case 1: return tc::launch<128, 64, 4, 2, 3, 2>(a, partial, splits, chunk, st);
    case 2: return tc::launch<64, 128, 2, 4, 3, 2>(a, partial, splits, chunk, st);
    case 3: return tc::launch<64, 64, 2, 2, 3, 3>(a, partial, splits, chunk, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
