// K3 on Hopper: int8 x int8 -> int32 direct convolution forward, dequantized
// in an f32 epilogue with the fused §II-G chain.
//
// Replaces the Pallas kernel repro/kernels/conv2d_q8.py:conv2d_q8
// (_kernel_q8_tiled).  Same function: x_q (N,H,W,C) int8 NHWC, w_q (R,S,C,K)
// int8 RSCK -> out (N,P,Q,K) f32 =
//   relu?(((f32(acc) * deq) * scale + shift) + bias + residual),
// acc the exact int32 sum and deq = x_scale * w_scale[k] (one f32 multiply).
// Built with nvcc for sm_90a and bound through the plain C function at the
// bottom (ctypes; see repro_torch/kernels/_build.py).
//
// What bounds it on an H100: at ResNet-50's batch-16 shapes the int8 work is
// small against the tensor cores' 1979 TOP/s, and the f32 output (4 bytes
// per element against 1 for each input) is the larger term: the bound is
// bytes.  So the design keeps every input byte moved once per block tile and
// writes the output once, straight from the accumulators.
//
// Design: K1's implicit GEMM, with the products on the tensor cores.
//   * M = N*P*Q output pixels (flattened across images), N_gemm = K, reduced
//     over (r, s, c).  A block owns a BM x BN output tile; each of its 8 warps
//     a (BM/WARPS_M) x (BN/WARPS_N) sub-tile of m16n8 int32 accumulators.
//   * Each reduction step stages one (r, s) and 32 input channels: the
//     im2col slice of BM pixels (32 bytes each, gathered straight from NHWC)
//     and the 32 x BN weight slice, double buffered through registers.  The
//     zero halo of `padding` and every ragged P/Q/C/K edge come from the load
//     masks: no padded copy.
//   * The weights are RSCK, so 4 consecutive channels of one k lie K bytes
//     apart.  Each thread loads a 4-channel x 4-k block as four words and
//     transposes it with __byte_perm, so shared memory holds words of 4
//     channels for one k: the "col" operand of mma.sync.
//   * mma.sync.m16n8k32.s32.s8.s8.s32 multiplies exactly; int32 sums are
//     associative, so the result does not depend on the order.
//     R*S*C*127^2 < 2^31 (checked by the wrapper) rules out overflow.
//   * Epilogue on the accumulators: __int2float_rn, then __fmul_rn by deq,
//     then K1's non-contracting scale, shift, bias, residual, relu, and one
//     store.  So the output equals the plain version bit for bit.
//   * mma_s8 and the epilogue live in q8_mma.cuh, shared with K10c's mma
//     route (conv2d_q8_whole.cu).
// Offsets into x, out and residual are 64-bit.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "q8_mma.cuh"

namespace {

constexpr int kThreads = 256;         // 8 warps
constexpr int kBK = 32;               // input channels per reduction step (mma k)
constexpr int kWords = kBK / 4;       // 32-bit words of 4 channels per row
constexpr int kRow = kWords + 4;      // padded shared row: conflict-free fragment loads

struct Q8Args {
  const int8_t* x;
  const int8_t* w;
  const float* x_scale;   // one f32
  const float* w_scale;   // (K,)
  const float* scale;     // may be null
  const float* shift;     // may be null
  const float* bias;      // may be null
  const float* residual;  // may be null, else (N,P,Q,K)
  float* out;
  int n, h, wd, c, k, r, s, stride, pad, p, q;
  int64_t m;  // N*P*Q
  int relu;
  int vec2;  // K even and out/residual 8-byte aligned
};

using q8::dequant_epilogue;
using q8::mma_s8;

// VEC: C % 16 == 0, K % 4 == 0, x 16-byte and w 4-byte aligned, so input
// channels load as whole vectors and weights as whole words; otherwise byte
// by byte, each masked on its own.
template <int BM, int BN, int WARPS_M, bool VEC>
__global__ void __launch_bounds__(kThreads)
conv2d_q8_kernel(const Q8Args a) {
  constexpr int WARPS_N = kThreads / 32 / WARPS_M;
  constexpr int WM = BM / WARPS_M;
  constexpr int WN = BN / WARPS_N;
  constexpr int MT = WM / 16;                       // m16 tiles per warp
  constexpr int NT = WN / 8;                        // n8 tiles per warp
  constexpr int kAPer = BM * kWords / kThreads;     // words of one pixel a thread stages
  constexpr int kAGroups = kWords / kAPer;          // threads per pixel
  constexpr int kBUnits = kWords * (BN / 4);        // 4-channel x 4-k weight blocks
  static_assert(MT >= 1 && NT >= 1 && WM % 16 == 0 && WN % 8 == 0, "warp tile");
  static_assert(kAPer == 2 || kAPer == 4, "a pixel stages as one 8- or 16-byte vector");
  static_assert(kBUnits <= kThreads, "one weight block per thread at most");

  __shared__ __align__(16) uint32_t As[2][BM][kRow];
  __shared__ __align__(16) uint32_t Bs[2][BN][kRow];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;   // mma groupID
  const int t = lane & 3;    // mma thread in group
  const int warp_m = warp / WARPS_N;
  const int warp_n = warp % WARPS_N;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int k0 = blockIdx.y * BN;

  // This thread stages words a_w0 .. a_w0+kAPer-1 of pixel a_pix.
  const int a_pix = tid / kAGroups;
  const int a_w0 = (tid % kAGroups) * kAPer;
  int a_ih0, a_iw0;
  int64_t a_base;
  {
    const int64_t m = m0 + a_pix;
    if (m < a.m) {
      const int qq = static_cast<int>(m % a.q);
      const int64_t tt = m / a.q;
      const int pp = static_cast<int>(tt % a.p);
      const int64_t nn = tt / a.p;
      a_ih0 = pp * a.stride - a.pad;
      a_iw0 = qq * a.stride - a.pad;
      a_base = nn * a.h * a.wd * a.c;
    } else {  // past the last pixel: every load of it is masked to zero
      a_ih0 = INT_MIN / 2;
      a_iw0 = INT_MIN / 2;
      a_base = 0;
    }
  }
  // ... and, if tid < kBUnits, the weight block of channels b_cq*4.. and
  // output channels b_kq*4..  Channel quads vary fastest, so a warp's
  // staging stores fall on at most two rows' banks at once.
  const int b_cq = tid % kWords;
  const int b_kq = tid / kWords;

  uint32_t a_reg[kAPer];
  uint32_t b_reg[4];

  auto load = [&](int rr, int ss, int c0) {
    const int ih = a_ih0 + rr;
    const int iw = a_iw0 + ss;
    const bool pix = static_cast<unsigned>(ih) < static_cast<unsigned>(a.h) &&
                     static_cast<unsigned>(iw) < static_cast<unsigned>(a.wd);
    const int ca = c0 + a_w0 * 4;
    const int8_t* xp = a.x + a_base + (static_cast<int64_t>(ih) * a.wd + iw) * a.c;
    if constexpr (VEC) {
      if (pix && ca < a.c) {
        if constexpr (kAPer == 4) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(xp + ca));
          a_reg[0] = v.x;
          a_reg[1] = v.y;
          a_reg[2] = v.z;
          a_reg[3] = v.w;
        } else {
          const uint2 v = __ldg(reinterpret_cast<const uint2*>(xp + ca));
          a_reg[0] = v.x;
          a_reg[1] = v.y;
        }
      } else {
#pragma unroll
        for (int j = 0; j < kAPer; ++j) a_reg[j] = 0u;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kAPer; ++j) {
        uint32_t word = 0u;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int cc = ca + j * 4 + b;
          if (pix && cc < a.c)
            word |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(xp + cc))) << (8 * b);
        }
        a_reg[j] = word;
      }
    }
    if (tid < kBUnits) {
      const int cb = c0 + b_cq * 4;
      const int kk = k0 + b_kq * 4;
      const int8_t* wp = a.w + static_cast<int64_t>(rr * a.s + ss) * a.c * a.k;
      if constexpr (VEC) {
        uint32_t row[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          row[i] = (cb + i < a.c && kk < a.k)
                       ? __ldg(reinterpret_cast<const uint32_t*>(
                             wp + static_cast<int64_t>(cb + i) * a.k + kk))
                       : 0u;
        // 4x4 byte transpose: row[i] holds k kk..kk+3 of channel cb+i;
        // b_reg[j] gets channels cb..cb+3 of k kk+j.
        const uint32_t t0 = __byte_perm(row[0], row[1], 0x5140);
        const uint32_t t1 = __byte_perm(row[0], row[1], 0x7362);
        const uint32_t t2 = __byte_perm(row[2], row[3], 0x5140);
        const uint32_t t3 = __byte_perm(row[2], row[3], 0x7362);
        b_reg[0] = __byte_perm(t0, t2, 0x5410);
        b_reg[1] = __byte_perm(t0, t2, 0x7632);
        b_reg[2] = __byte_perm(t1, t3, 0x5410);
        b_reg[3] = __byte_perm(t1, t3, 0x7632);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t word = 0u;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int cc = cb + i;
            if (cc < a.c && kk + j < a.k)
              word |= static_cast<uint32_t>(static_cast<uint8_t>(
                          __ldg(wp + static_cast<int64_t>(cc) * a.k + kk + j)))
                      << (8 * i);
          }
          b_reg[j] = word;
        }
      }
    }
  };

  auto stage = [&](int buf) {
    if constexpr (kAPer == 4) {
      *reinterpret_cast<uint4*>(&As[buf][a_pix][a_w0]) =
          make_uint4(a_reg[0], a_reg[1], a_reg[2], a_reg[3]);
    } else {
      *reinterpret_cast<uint2*>(&As[buf][a_pix][a_w0]) = make_uint2(a_reg[0], a_reg[1]);
    }
    if (tid < kBUnits) {
#pragma unroll
      for (int j = 0; j < 4; ++j) Bs[buf][b_kq * 4 + j][b_cq] = b_reg[j];
    }
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][j][u] = 0;

  const int c_steps = (a.c + kBK - 1) / kBK;
  const int steps = a.r * a.s * c_steps;
  int rr = 0, ss = 0, c0 = 0;
  load(rr, ss, c0);
  stage(0);
  __syncthreads();

  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    const bool more = step + 1 < steps;
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
    uint32_t af[MT][4], bf[NT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int row = warp_m * WM + i * 16 + g;
      af[i][0] = As[buf][row][t];
      af[i][1] = As[buf][row + 8][t];
      af[i][2] = As[buf][row][t + 4];
      af[i][3] = As[buf][row + 8][t + 4];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = warp_n * WN + j * 8 + g;
      bf[j][0] = Bs[buf][col][t];
      bf[j][1] = Bs[buf][col][t + 4];
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    if (more) stage(buf ^ 1);
    __syncthreads();
  }

  // Dequantize, then the fused epilogue (reference order: scale, shift,
  // bias, residual, relu).  Accumulator u of tile (i, j) sits at row
  // g (+8 for u >= 2) and column 2t + (u & 1).
  const float xs = *a.x_scale;
  float dq[NT][2], sc[NT][2], sh[NT][2], bi[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int kk = k0 + warp_n * WN + j * 8 + 2 * t + v;
      const bool in = kk < a.k;
      dq[j][v] = in ? __fmul_rn(xs, a.w_scale[kk]) : 0.f;
      sc[j][v] = (in && a.scale) ? a.scale[kk] : 1.f;
      sh[j][v] = (in && a.shift) ? a.shift[kk] : 0.f;
      bi[j][v] = (in && a.bias) ? a.bias[kk] : 0.f;
    }
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t m = m0 + warp_m * WM + i * 16 + g + half * 8;
      if (m >= a.m) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int kk = k0 + warp_n * WN + j * 8 + 2 * t;
        if (kk >= a.k) continue;
        const int64_t off = m * a.k + kk;
        float res[2] = {0.f, 0.f};
        if (a.residual) {
          if (a.vec2) {
            const float2 rv = *reinterpret_cast<const float2*>(a.residual + off);
            res[0] = rv.x;
            res[1] = rv.y;
          } else {
            res[0] = a.residual[off];
            if (kk + 1 < a.k) res[1] = a.residual[off + 1];
          }
        }
        float v[2];
#pragma unroll
        for (int u = 0; u < 2; ++u)
          v[u] = dequant_epilogue(a, acc[i][j][half * 2 + u], dq[j][u], sc[j][u], sh[j][u],
                                  bi[j][u], res[u]);
        if (a.vec2) {
          *reinterpret_cast<float2*>(a.out + off) = make_float2(v[0], v[1]);
        } else {
          a.out[off] = v[0];
          if (kk + 1 < a.k) a.out[off + 1] = v[1];
        }
      }
    }
}

template <int BM, int BN, int WARPS_M>
void launch(const Q8Args& a, bool vec, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((a.m + BM - 1) / BM), (a.k + BN - 1) / BN);
  if (vec)
    conv2d_q8_kernel<BM, BN, WARPS_M, true><<<grid, kThreads, 0, stream>>>(a);
  else
    conv2d_q8_kernel<BM, BN, WARPS_M, false><<<grid, kThreads, 0, stream>>>(a);
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

bool aligned(const void* ptr, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(ptr) & (bytes - 1)) == 0;
}

}  // namespace

// Launches K3 on `stream` without synchronising and returns
// cudaGetLastError(): nonzero means the launch was refused or an earlier
// fault is pending.  The caller checks shapes, dtypes, contiguity and the
// int32 overflow bound.
extern "C" int repro_conv2d_q8(const int8_t* x, const int8_t* w, const float* x_scale,
                               const float* w_scale, const float* scale, const float* shift,
                               const float* bias, const float* residual, float* out, int n,
                               int h, int wd, int c, int k, int r, int s, int stride, int pad,
                               int relu, void* stream) {
  Q8Args a;
  a.x = x;
  a.w = w;
  a.x_scale = x_scale;
  a.w_scale = w_scale;
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
  a.vec2 = (k % 2 == 0) && aligned(out, 8) && (residual == nullptr || aligned(residual, 8));
  if (a.m <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = c % 16 == 0 && k % 4 == 0 && aligned(x, 16) && aligned(w, 4);

  // Largest tile that still gives every SM a block; the small late-stage
  // planes (7x7, 14x14) drop to narrower tiles instead of idling SMs.
  const int sms = sm_count();
  auto blocks = [&](int bm, int bn) { return ((a.m + bm - 1) / bm) * ((k + bn - 1) / bn); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k > 64 && blocks(128, 128) >= sms) {
    launch<128, 128, 2>(a, vec, st);
  } else if (blocks(128, 64) >= sms) {
    launch<128, 64, 4>(a, vec, st);
  } else {
    launch<64, 64, 2>(a, vec, st);
  }
  return static_cast<int>(cudaGetLastError());
}
