// K10b on Hopper: the weight-gradient ("update pass") convolution, §II-J, by
// the reference's legacy whole-plane strategy.
//
// Replaces the Pallas kernel repro/kernels/conv2d_wu.py:_conv2d_wu_whole
// (_kernel_whole).  Same function as K2 (csrc/conv2d_wu.cu): from xp, the
// padded plane (N,HP,WP,C) that the wrapper makes with pad_input, and dO
// (N,P,Q,K),
//   dW[r,s,c,k] = sum over (n,p,q) of xp[n, p*st+r, q*st+s, c] * dO[n,p,q,k]
// -> dW (R,S,C,K), f32 accumulation.  Built with nvcc for sm_90a and bound
// through the plain C function at the bottom (ctypes; see
// repro_torch/kernels/_build.py).
//
// The strategy, as the reference has it: the dW tile of a block stays
// resident (here in registers) across the whole (n, p_b) sweep, and each
// step reads a b_p-row block of dO and the matching rows of the padded plane.
// The reference's block is (R, S, C, k_blk), far more than a block's
// registers, so on the card a block owns one (r, s) tap and a BM x BN tile of
// (C, k_blk); the grid is (C tiles, K_b, R*S).  Differences from K2:
//   * no split of the pixels across blocks and no second reduction pass: one
//     block sums all N*P*Q pixels of its tile in a fixed order, so the result
//     is deterministic (no atomics, the same bits on every run);
//   * the sweep is the reference's, image by image and b_p rows at a time
//     (b_p divides P: the wrapper checks), in groups of 8 pixels staged in
//     shared memory, double buffered through registers; a group past the
//     step's b_p*Q pixels loads zeros;
//   * loads read the padded plane, with no bounds test on rows or columns;
//   * each step's products are summed in a step tile first and then added
//     to the resident dW tile, as the reference adds each step's dot
//     product to its output block: no one running sum takes all N*P*Q
//     pixels (100,352 at the 56x56 layers at batch 32) one at a time.
// Where C x K gives fewer tiles than the 132 SMs it leaves SMs idle; that is
// the strategy's cost on this card, measured beside K2 by chip_smoke.py.
// Offsets into xp and dO are 64-bit.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 8;  // pixels per staged group

struct WuWholeArgs {
  const float* xp;    // padded plane (N, HP, WP, C)
  const float* dout;  // (N, P, Q, K)
  float* dw;          // (R, S, C, K)
  int n, hp, wp, c, k, r, s, stride, p, q, b_p, k_blk;
};

template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
conv2d_wu_whole_kernel(const WuWholeArgs a) {
  static_assert((BM / TM) * (BN / TN) == kThreads, "one register tile per thread");
  static_assert(TM % 4 == 0 && TN % 4 == 0, "register tiles are float4 groups");
  static_assert(kThreads % BM == 0 && kThreads % BN == 0, "fixed channel per thread");
  constexpr int kAPer = BM * kPix / kThreads;  // x values a thread stages per group
  constexpr int kBPer = BN * kPix / kThreads;  // dO values a thread stages per group
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
  const int k0 = blockIdx.y * a.k_blk;
  const int rr = blockIdx.z / a.s;
  const int ss = blockIdx.z % a.s;
  const int step_pixels = a.b_p * a.q;
  const int groups = (step_pixels + kPix - 1) / kPix;
  const int p_b = a.p / a.b_p;
  const int steps = a.n * p_b * groups;

  const int a_c = c0 + tid % BM;
  const bool a_c_ok = a_c < a.c;
  const int b_kl = tid % BN;  // output channel within the block
  const bool b_k_ok = b_kl < a.k_blk;

  float a_reg[kAPer];
  float b_reg[kBPer];

  auto load = [&](int t) {  // group t of the sweep: image, row block, 8 pixels
    const int g = t % groups;
    const int rest = t / groups;
    const int pb = rest % p_b;
    const int nn = rest / p_b;
#pragma unroll
    for (int i = 0; i < kAPer; ++i) {
      const int px = g * kPix + tid / BM + i * kARows;
      const int pl = px / a.q;
      const int qq = px - pl * a.q;
      const int row = (pb * a.b_p + pl) * a.stride + rr;
      const int col = qq * a.stride + ss;
      a_reg[i] = (a_c_ok && px < step_pixels)
                     ? __ldg(a.xp + (static_cast<int64_t>(nn * a.hp + row) * a.wp + col) * a.c + a_c)
                     : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kBPer; ++j) {
      const int px = g * kPix + tid / BN + j * kBRows;
      const int pl = px / a.q;
      const int qq = px - pl * a.q;
      b_reg[j] = (b_k_ok && px < step_pixels)
                     ? __ldg(a.dout +
                             (static_cast<int64_t>(nn * a.p + pb * a.b_p + pl) * a.q + qq) * a.k +
                             k0 + b_kl)
                     : 0.f;
    }
  };

  auto stage = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kAPer; ++i) As[buf][tid / BM + i * kARows][tid % BM] = a_reg[i];
#pragma unroll
    for (int j = 0; j < kBPer; ++j) Bs[buf][tid / BN + j * kBRows][tid % BN] = b_reg[j];
  };

  float acc[TM][TN], step[TM][TN];  // the resident tile, this step's sum
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = step[i][j] = 0.f;

  load(0);
  stage(0);
  __syncthreads();

  for (int t = 0; t < steps; ++t) {
    const int buf = t & 1;
    const bool more = t + 1 < steps;
    if (more) load(t + 1);
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
        for (int j = 0; j < TN; ++j) step[i][j] = fmaf(af[i], bf[j], step[i][j]);
    }
    if (t % groups == groups - 1) {  // the step's last group: fold it in
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[i][j] += step[i][j];
          step[i][j] = 0.f;
        }
    }
    if (more) stage(buf ^ 1);
    __syncthreads();
  }

  float* out = a.dw + static_cast<int64_t>(blockIdx.z) * a.c * a.k;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int cc = c0 + (i / 4) * kMGroup + ty * 4 + (i % 4);
    if (cc >= a.c) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int kl = (j / 4) * kNGroup + tx * 4 + (j % 4);
      if (kl < a.k_blk) out[static_cast<int64_t>(cc) * a.k + k0 + kl] = acc[i][j];
    }
  }
}

template <int BM, int BN, int TM, int TN>
int launch(const WuWholeArgs& a, cudaStream_t stream) {
  const dim3 grid((a.c + BM - 1) / BM, a.k / a.k_blk, a.r * a.s);
  conv2d_wu_whole_kernel<BM, BN, TM, TN><<<grid, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches K10b on `stream` without synchronising and returns
// cudaGetLastError(): nonzero means the launch was refused or an earlier
// fault is pending.  The caller pads the plane (pad_input), checks shapes,
// dtypes, contiguity, that b_p divides P and that k_blk divides K, and picks
// the tile (kernels/conv2d_wu.WHOLE_TILES: C x K of 128x128, 128x64, 64x128
// or 64x64, with k_blk no more than the tile's K).
extern "C" int repro_conv2d_wu_whole_f32(const float* xp, const float* dout, float* dw, int n,
                                         int hp, int wp, int c, int k, int r, int s, int stride,
                                         int p, int q, int b_p, int k_blk, int tile,
                                         void* stream) {
  WuWholeArgs a;
  a.xp = xp;
  a.dout = dout;
  a.dw = dw;
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
  a.b_p = b_p;
  a.k_blk = k_blk;
  if (n <= 0 || p <= 0 || q <= 0 || b_p <= 0 || p % b_p || k_blk <= 0 || k % k_blk)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 0: return k_blk <= 128 ? launch<128, 128, 8, 8>(a, st) : static_cast<int>(cudaErrorInvalidValue);
    case 1: return k_blk <= 64 ? launch<128, 64, 8, 4>(a, st) : static_cast<int>(cudaErrorInvalidValue);
    case 2: return k_blk <= 128 ? launch<64, 128, 4, 8>(a, st) : static_cast<int>(cudaErrorInvalidValue);
    case 3: return k_blk <= 64 ? launch<64, 64, 4, 4>(a, st) : static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
