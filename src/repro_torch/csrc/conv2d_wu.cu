// K2 on Hopper: the weight-gradient ("update pass") convolution, §II-J.
//
// Replaces the Pallas kernel repro/kernels/conv2d_wu.py:conv2d_wu
// (_kernel_tiled).  Same function: from x (N,H,W,C) NHWC and dO (N,P,Q,K)
// NPQK,
//   dW[r,s,c,k] = sum over (n,p,q) of x[n, p*st+r-pad, q*st+s-pad, c] * dO[n,p,q,k]
// -> dW (R,S,C,K) RSCK, f32 accumulation.  Built with nvcc for sm_90a and
// bound through the plain C functions at the bottom (ctypes; see
// repro_torch/kernels/_build.py).
//
// What bounds it: 2*N*P*Q*K*C*R*S FLOPs against reading x and dO once and
// writing dW once.  At ResNet-50's batch-32 shapes every weight gradient
// but the 56x56 1x1 64->64 one lies above the f32 ridge of 67 TFLOP/s over
// 3.35 TB/s, so on the SIMT cores the bound is their f32 FMA rate; on the
// tensor cores (the mma route) it is three TF32 products per f32 one at
// 494.7 TFLOP/s, or the bytes where those take longer.
//
// Why it does not follow the TPU kernel: that kernel keeps one
// (R,S,C_blk,K_blk) tile in VMEM across a sequential (n, p, q) grid sweep.
// On the card blocks run in parallel and nothing carries between them, and
// the dW tile is small against a long reduction (the 56x56 1x1 64->64 conv
// has 4,096 outputs and 100,352 pixels to sum), so one block per output tile
// would leave most of the 132 SMs idle.  The design, shared by both routes:
//   * Per (r, s) a GEMM with M = C, N = K, reduced over the N*P*Q pixels.  A
//     block owns a BM x BN (C x K) tile of one (r, s) and one chunk of the
//     pixels, staging pixels of x (the input position p*st+r-pad,
//     q*st+s-pad, read along C) and of dO (read along K) in shared memory,
//     both loads coalesced along the output's dimensions.  The zero halo and
//     every ragged P, Q, C and K edge come from load masks: no padded copy.
//   * Split-K over pixels, the §II-J "private copies" strategy mapped onto
//     blocks: each of `splits` chunks writes an f32 partial tile into a
//     scratch (splits, R, S, C, K); a second kernel sums the partials in a
//     fixed order.  Deterministic run to run, no atomics.  With splits == 1
//     the first kernel writes dW itself and the second does not run.  The
//     wrapper chooses splits from the shape (about two blocks per SM, a
//     bounded chunk of pixels per block).
//
// Two routes, chosen in the wrapper (kernels/conv2d_wu.route):
//
// conv2d_wu_kernel_mma, for C and K multiples of 4 and 16-byte aligned x and
// dO (every ResNet-50 signature): the f32 products on the tensor cores by
// the 3xTF32 split.  One-pass TF32 keeps 11 bits of each operand and would
// break the f32 parity (1e-5 of max |dW|); the split keeps about 22:
//   * each fragment value v becomes hi = tf32(v) (cvt.rna) and lo =
//     tf32(v - hi); mma.sync m16n8k8 tf32 adds lo*hi, hi*lo, then hi*hi
//     (lo*lo, below f32's last bit, is dropped);
//   * a ring of 3 or 4 stages of 32 pixels, filled by 16-byte cp.async
//     copies (zero-filled on the halo and the tails), keeps loads in flight
//     while a stage is multiplied; shared rows are padded by 8 floats, so
//     the fragment loads along the pixel axis hit 32 distinct banks;
//   * the tensor cores' adder may round toward zero, so a long run of mma
//     sums would drift (about 1e-5 of max |dW| over 1,024 pixels in a CPU
//     emulation): each stage's products add up in a zeroed accumulator,
//     which is then added to the block's f32 sums on the SIMT cores
//     (round to nearest), so no tensor-core run holds more than 12 products;
//   * warps of 32 x 64 or 32 x 32 of the block's tile; 128 x 128 blocks
//     run one an SM (4 stages, 136 KB), the smaller ones two or three.
//
// conv2d_wu_kernel, every other shape: f32 FMA on the SIMT cores.  Each
// reduction step stages 8 pixels in shared memory, double buffered through
// registers, and each thread keeps a TM x TN register tile of dW (the
// paper's register blocking).
// Pixel indices are 32-bit (the wrapper checks N*P*Q < 2^31); offsets into
// x, dO and the scratch are 64-bit.
#include <cstdint>

#include <cuda_runtime.h>

#include "conv_tf32.cuh"

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

// ---- the mma route: 3xTF32 on the tensor cores ------------------------------

namespace tc {

constexpr int kBK = 32;   // pixels of a ring stage
constexpr int kPad = 8;   // floats past each shared row: conflict-free fragments

// smem_addr, cp_async16, cp_async_commit, cp_async_wait, split_tf32 and
// mma_tf32 come from conv_tf32.cuh.

// A BM x BN block of WM x WN warps, STAGES ring stages, MINB blocks an SM.
template <int BM, int BN, int WM, int WN, int STAGES, int MINB>
struct Cfg {
  static constexpr int kThreads = WM * WN * 32;
  static constexpr int kWTM = BM / WM, kWTN = BN / WN;  // a warp's tile
  static constexpr int MT = kWTM / 16, NT = kWTN / 8;   // its m16n8 tiles
  static constexpr int kAS = BM + kPad, kBS = BN + kPad;
  static constexpr int kStageFloats = kBK * (kAS + kBS);
  static constexpr int kSmem = STAGES * kStageFloats * 4;
  static constexpr int kAPer = kBK * BM / 4 / kThreads;  // x copies a thread makes a stage
  static constexpr int kBPer = kBK * BN / 4 / kThreads;  // dO copies
  static_assert(kWTM % 16 == 0 && kWTN % 8 == 0, "m16n8 tiles");
  static_assert(kAPer >= 1 && kBPer >= 1 && kThreads % (BM / 4) == 0 &&
                    kThreads % (BN / 4) == 0,
                "a fixed 4-channel group per thread");
};

template <int BM, int BN, int WM, int WN, int STAGES, int MINB>
__global__ void __launch_bounds__(WM * WN * 32, MINB)
conv2d_wu_kernel_mma(const WuArgs a) {
  using G = Cfg<BM, BN, WM, WN, STAGES, MINB>;
  constexpr int MT = G::MT, NT = G::NT;
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int wm0 = (warp / WN) * G::kWTM, wn0 = (warp % WN) * G::kWTN;
  const int c0 = blockIdx.x * BM;
  const int k0 = blockIdx.y * BN;
  const int rs_count = a.r * a.s;
  const int rs = blockIdx.z % rs_count;
  const int split = blockIdx.z / rs_count;
  const int rr = rs / a.s;
  const int ss = rs % a.s;
  const int m_begin = split * a.chunk;
  const int m_end = min(m_begin + a.chunk, a.m);
  const bool direct = a.r == 1 && a.s == 1 && a.stride == 1 && a.pad == 0;

  // this thread copies channels a_c .. a_c+3 of the stage's pixel rows
  // tid / (BM/4) + i * (threads / (BM/4)), and output channels b_k .. b_k+3
  const int a_c = c0 + (tid % (BM / 4)) * 4;
  const int b_k = k0 + (tid % (BN / 4)) * 4;
  const bool a_c_ok = a_c < a.c, b_k_ok = b_k < a.k;

  auto load = [&](int buf, int m0) {
    float* as = smem + buf * G::kStageFloats;
    float* bs = as + kBK * G::kAS;
#pragma unroll
    for (int i = 0; i < G::kAPer; ++i) {
      const int row = tid / (BM / 4) + i * (G::kThreads / (BM / 4));
      const int m = m0 + row;
      const float* src = a.x;
      bool ok = a_c_ok && m < m_end;
      if (ok) {
        if (direct) {
          src = a.x + static_cast<int64_t>(m) * a.c + a_c;
        } else {
          const int q = m % a.q;
          const int t = m / a.q;
          const int p = t % a.p;
          const int n = t / a.p;
          const int ih = p * a.stride + rr - a.pad;
          const int iw = q * a.stride + ss - a.pad;
          ok = static_cast<unsigned>(ih) < static_cast<unsigned>(a.h) &&
               static_cast<unsigned>(iw) < static_cast<unsigned>(a.wd);
          if (ok) src = a.x + (static_cast<int64_t>(n * a.h + ih) * a.wd + iw) * a.c + a_c;
        }
      }
      cp_async16(as + row * G::kAS + (tid % (BM / 4)) * 4, src, ok ? 16 : 0);
    }
#pragma unroll
    for (int j = 0; j < G::kBPer; ++j) {
      const int row = tid / (BN / 4) + j * (G::kThreads / (BN / 4));
      const int m = m0 + row;
      const bool ok = b_k_ok && m < m_end;
      cp_async16(bs + row * G::kBS + (tid % (BN / 4)) * 4,
                 ok ? a.dout + static_cast<int64_t>(m) * a.k + b_k : a.dout, ok ? 16 : 0);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  const int steps = m_end > m_begin ? (m_end - m_begin + kBK - 1) / kBK : 0;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < steps) load(st, m_begin + st * kBK);
    cp_async_commit();
  }
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<STAGES - 2>();  // stage t has landed
    __syncthreads();              // and every warp is done with stage t - 1
    const int nxt = t + STAGES - 1;
    if (nxt < steps) load(nxt % STAGES, m_begin + nxt * kBK);
    cp_async_commit();

    const float* as = smem + (t % STAGES) * G::kStageFloats;
    const float* bs = as + kBK * G::kAS;
    // this stage's 32 pixels add up in a zeroed accumulator, then join the
    // block's f32 sums: a tensor-core run holds at most 12 products
    float run[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) run[i][j][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float* col = as + (kk + tig) * G::kAS + wm0 + i * 16 + g;
        split_tf32(col[0], ah[i][0], al[i][0]);                   // (g, tig)
        split_tf32(col[8], ah[i][1], al[i][1]);                   // (g + 8, tig)
        split_tf32(col[4 * G::kAS], ah[i][2], al[i][2]);          // (g, tig + 4)
        split_tf32(col[4 * G::kAS + 8], ah[i][3], al[i][3]);      // (g + 8, tig + 4)
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* col = bs + (kk + tig) * G::kBS + wn0 + j * 8 + g;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(col[0], bh0, bl0);                             // (tig, g)
        split_tf32(col[4 * G::kBS], bh1, bl1);                    // (tig + 4, g)
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
  cp_async_wait<0>();

  // blockIdx.z = split * R*S + rs: the tile lands at out[split][r][s][c][k];
  // K % 4 == 0, so each (c, k..k+1) pair is one aligned float2
  float* out = a.out + static_cast<int64_t>(blockIdx.z) * a.c * a.k;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int kk = k0 + wn0 + j * 8 + 2 * tig;
      if (kk >= a.k) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int cc = c0 + wm0 + i * 16 + g + 8 * h;
        if (cc < a.c)
          *reinterpret_cast<float2*>(out + static_cast<int64_t>(cc) * a.k + kk) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
}

template <int BM, int BN, int WM, int WN, int STAGES, int MINB>
int launch(const WuArgs& a, int splits, cudaStream_t stream) {
  using G = Cfg<BM, BN, WM, WN, STAGES, MINB>;
  auto kernel = conv2d_wu_kernel_mma<BM, BN, WM, WN, STAGES, MINB>;
  // per call: the attribute belongs to the current device
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.c + BM - 1) / BM, (a.k + BN - 1) / BN, splits * a.r * a.s);
  kernel<<<grid, G::kThreads, G::kSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Fills `a` from the C functions' arguments; false for arguments no route
// takes.
bool make_args(WuArgs& a, const float* x, const float* dout, float* partial, float* dw, int n,
               int h, int wd, int c, int k, int r, int s, int stride, int pad, int splits,
               int chunk) {
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
    return false;
  a.m = static_cast<int>(m);
  a.chunk = chunk;
  return true;
}

// The second pass: dw = the partials summed in split order (splits > 1).
int reduce(const float* partial, float* dw, int r, int s, int c, int k, int splits,
           cudaStream_t st) {
  const int64_t len = static_cast<int64_t>(r) * s * c * k;
  const int64_t blocks = (len + kThreads - 1) / kThreads;
  const unsigned grid = static_cast<unsigned>(blocks < 4096 ? blocks : 4096);
  wu_reduce_kernel<<<grid, kThreads, 0, st>>>(partial, dw, len, splits);
  return static_cast<int>(cudaGetLastError());
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
  if (!make_args(a, x, dout, partial, dw, n, h, wd, c, k, r, s, stride, pad, splits, chunk))
    return static_cast<int>(cudaErrorInvalidValue);

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 0: launch<128, 128, 8, 8>(a, splits, st); break;
    case 1: launch<128, 64, 8, 4>(a, splits, st); break;
    case 2: launch<64, 64, 4, 4>(a, splits, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || splits == 1) return err;
  return reduce(partial, dw, r, s, c, k, splits, st);
}

// The mma route (3xTF32 on the tensor cores), with the arguments of
// repro_conv2d_wu_f32: C and K must be multiples of 4 and x, dout, partial
// and dw 16-byte aligned (kernels/conv2d_wu.route); `tile` selects 0 =
// 128x128, 1 = 128x64, 2 = 64x128, 3 = 64x64 (C x K); the chunk must be a
// multiple of the 32-pixel stage.  Returns cudaErrorInvalidValue for
// arguments off that rule, else the first nonzero CUDA error.
extern "C" int repro_conv2d_wu_mma(const float* x, const float* dout, float* partial, float* dw,
                                   int n, int h, int wd, int c, int k, int r, int s, int stride,
                                   int pad, int tile, int splits, int chunk, void* stream) {
  WuArgs a;
  if (c % 4 != 0 || k % 4 != 0 || chunk % tc::kBK != 0 || !aligned16(x) || !aligned16(dout) ||
      !aligned16(dw) || (splits > 1 && !aligned16(partial)) ||
      !make_args(a, x, dout, partial, dw, n, h, wd, c, k, r, s, stride, pad, splits, chunk))
    return static_cast<int>(cudaErrorInvalidValue);

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  switch (tile) {
    case 0: err = tc::launch<128, 128, 4, 2, 4, 1>(a, splits, st); break;
    case 1: err = tc::launch<128, 64, 4, 2, 3, 2>(a, splits, st); break;
    case 2: err = tc::launch<64, 128, 2, 4, 3, 2>(a, splits, st); break;
    case 3: err = tc::launch<64, 64, 2, 2, 3, 3>(a, splits, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0 || splits == 1) return err;
  return reduce(partial, dw, r, s, c, k, splits, st);
}
