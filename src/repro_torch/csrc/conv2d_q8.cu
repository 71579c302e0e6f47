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

// ---------------------------------------------------------------------------
// The "ring" route: conv2d_q8_kernel_ring.
//
// Replaces the same Pallas kernel (repro/kernels/conv2d_q8.py:conv2d_q8) for
// C % 16 == 0 and K % 8 == 0 (every ResNet-50 int8 conv; the wrapper's
// route() picks it).  Same function and the same bits: exact int32 sums,
// then q8::dequant_epilogue in the reference's order.
//
// What bounds it: bytes, as above (the f32 output and residual dominate; the
// int8 operations take about a fifth of the bytes' time at 1979 TOP/s).  The
// route above lost most of its time on the small late-stage planes, far from
// either bound; the design answers each of its four losses:
//   1. One 32-channel step per barrier, staged through registers: here each
//      ring stage holds one (r, s) and BK = 64 or 128 input channels (2 or 4
//      k32 steps of every warp per barrier), and the ring has 3 or 4 stages
//      in dynamic shared memory, filled by 16-byte cp.async (zero-filled,
//      src-size 0, on the padding halo and the P/Q/C/K tails), so 2 or 3
//      stages of loads are in flight while the warps multiply.
//   2. Weights transposed with __byte_perm in every block and step: the
//      wrapper lays them out once, (R, S, K, C) with C contiguous
//      (kernels/conv2d_q8.py weight_words, cached across calls), so a
//      weight row of a stage is whole 16-byte chunks, the "col" operand of
//      mma.sync as it lies.  Fragments of both operands come from ldmatrix
//      on rows padded to BK + 16 bytes: the 8 rows of one 8x16-byte matrix
//      fall on 8 distinct 4-bank groups, free of conflicts.
//   3. Small grids walking long reductions: the wrapper's ring_plan splits
//      the (r, s, c) steps across gridDim.z CTAs wherever the output tiles
//      leave the card's 132 SMs under-filled.  Each split writes its int32
//      partial tile to scratch; the last CTA of a tile to arrive (a counter
//      per tile, reset by that CTA, so the counters are zero again for the
//      next launch) adds the others' partials and runs the epilogue.  int32
//      sums are exact in any order, so the split changes no bit, and a conv
//      stays one launch.
//   4. Strided float2 stores from the mma fragment layout: the int32 tile is
//      staged through shared memory, and each warp then reads the residual
//      and stores the f32 output as whole 128-byte lines, 16 bytes a thread.
// Offsets into x, out and residual are 64-bit.

constexpr int kRingTwoBlocks = 233472 / 2 - 1024;  // shared memory of one of two blocks an SM
constexpr int kRingMaxStages = 4;

// The most stages up to kRingMaxStages that leave room for two blocks an
// SM, and at least 3.
constexpr int ring_stages(int stage_bytes) {
  int n = kRingMaxStages;
  while (n > 3 && n * stage_bytes > kRingTwoBlocks) --n;
  return n;
}

struct Q8RingArgs {
  const int8_t* x;
  const int8_t* w;        // (R, S, K, C) int8, C contiguous
  const float* x_scale;   // one f32
  const float* w_scale;   // (K,)
  const float* scale;     // may be null
  const float* shift;     // may be null
  const float* bias;      // may be null
  const float* residual;  // may be null, else (N,P,Q,K), 16-byte aligned
  float* out;
  int* partial;           // splits > 1: (tiles, splits, BM, BN) int32
  int* counters;          // splits > 1: (tiles,) int32, zero between launches
  int n, h, wd, c, k, r, s, stride, pad, p, q;
  int64_t m;  // N*P*Q
  int relu, splits, c_steps;
};

// The shared memory of one (BM, BN, BK) instance: the ring, and after the
// mainloop the int32 output tile (rows of BN + 8 words) with the per-column
// dequant and epilogue factors.  A split of fewer steps than the ring has
// stages touches only as many slots, so a launch claims smem(steps) bytes
// (more blocks fit an SM on the one- and two-step 1x1 convs).
// kernels/conv2d_q8.py ring_plan repeats it.
template <int BM, int BN, int BK>
struct RingShape {
  static constexpr int kRowBytes = BK + 16;
  static constexpr int kStageBytes = (BM + BN) * kRowBytes;
  static constexpr int kStages = ring_stages(kStageBytes);
  static constexpr int kOutStride = BN + 8;
  static constexpr int kEpiBytes = BM * kOutStride * 4 + 4 * BN * 4;
  static constexpr int smem(int steps) {
    return (steps < kStages ? steps : kStages) * kStageBytes > kEpiBytes
               ? (steps < kStages ? steps : kStages) * kStageBytes
               : kEpiBytes;
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&d)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(addr));
}

// grid (ceil(M / BM), ceil(K / BN), splits); 256 threads, RingShape::kSmem
// bytes of dynamic shared memory.
template <int BM, int BN, int BK, int WARPS_M>
__global__ void __launch_bounds__(kThreads)
conv2d_q8_kernel_ring(const Q8RingArgs a) {
  using Shape = RingShape<BM, BN, BK>;
  constexpr int kStages = Shape::kStages;
  constexpr int kRowBytes = Shape::kRowBytes;
  constexpr int kStageBytes = Shape::kStageBytes;
  constexpr int kOutStride = Shape::kOutStride;
  constexpr int WARPS_N = kThreads / 32 / WARPS_M;
  constexpr int WM = BM / WARPS_M;
  constexpr int WN = BN / WARPS_N;
  constexpr int MT = WM / 16;              // m16 tiles per warp
  constexpr int NT = WN / 8;               // n8 tiles per warp
  constexpr int kChunks = BK / 16;         // 16-byte chunks of a staged row
  constexpr int kRowsPass = kThreads / kChunks;
  constexpr int kAIt = BM / kRowsPass;
  constexpr int kBIt = BN / kRowsPass;
  static_assert(MT >= 1 && NT >= 2 && NT % 2 == 0, "warp tile");
  static_assert(kAIt >= 1 && kBIt >= 1 && BM % kRowsPass == 0 && BN % kRowsPass == 0,
                "whole rows a pass");
  extern __shared__ __align__(128) uint8_t smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int warp_m = warp / WARPS_N;
  const int warp_n = warp % WARPS_N;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int k0 = blockIdx.y * BN;
  const int split = blockIdx.z;
  const int total = a.r * a.s * a.c_steps;
  const int t_begin = static_cast<int>(static_cast<int64_t>(total) * split / a.splits);
  const int t_end = static_cast<int>(static_cast<int64_t>(total) * (split + 1) / a.splits);
  const int nsteps = t_end - t_begin;

  // This thread copies chunk `chunk` of rows row0 + i * kRowsPass of both
  // operands.  A row past the last pixel gets coordinates no (r, s) brings
  // inside the plane, so its loads zero-fill.
  const int chunk = tid % kChunks;
  const int row0 = tid / kChunks;
  int64_t a_base[kAIt];
  int a_ih[kAIt], a_iw[kAIt];
#pragma unroll
  for (int i = 0; i < kAIt; ++i) {
    const int64_t m = m0 + row0 + i * kRowsPass;
    if (m < a.m) {
      const int qq = static_cast<int>(m % a.q);
      const int64_t tt = m / a.q;
      const int pp = static_cast<int>(tt % a.p);
      const int64_t nn = tt / a.p;
      a_ih[i] = pp * a.stride - a.pad;
      a_iw[i] = qq * a.stride - a.pad;
      a_base[i] = nn * a.h * a.wd * a.c;
    } else {
      a_ih[i] = INT_MIN / 2;
      a_iw[i] = INT_MIN / 2;
      a_base[i] = 0;
    }
  }
  const unsigned ring = smem_addr(smem);

  auto load_stage = [&](int slot, int t) {
    const int c_step = t % a.c_steps;
    const int rs = t / a.c_steps;
    const int rr = rs / a.s;
    const int ss = rs - rr * a.s;
    const int cc = c_step * BK + chunk * 16;
    const bool c_in = cc < a.c;
    const unsigned as = ring + slot * kStageBytes + chunk * 16;
    const unsigned bs = as + BM * kRowBytes;
#pragma unroll
    for (int i = 0; i < kAIt; ++i) {
      const int ih = a_ih[i] + rr;
      const int iw = a_iw[i] + ss;
      const bool ok = c_in && static_cast<unsigned>(ih) < static_cast<unsigned>(a.h) &&
                      static_cast<unsigned>(iw) < static_cast<unsigned>(a.wd);
      const int8_t* src =
          ok ? a.x + a_base[i] + (static_cast<int64_t>(ih) * a.wd + iw) * a.c + cc : a.x;
      cp_async16(as + (row0 + i * kRowsPass) * kRowBytes, src, ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < kBIt; ++i) {
      const int kk = k0 + row0 + i * kRowsPass;
      const bool ok = c_in && kk < a.k;
      const int8_t* src = ok ? a.w + (static_cast<int64_t>(rs) * a.k + kk) * a.c + cc : a.w;
      cp_async16(bs + (row0 + i * kRowsPass) * kRowBytes, src, ok ? 16 : 0);
    }
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][j][u] = 0;

  // ldmatrix row addresses: lanes 0-15 give the rows of an m16 tile's
  // first 16 channel bytes, lanes 16-31 its next 16 (a0..a3 of mma.sync);
  // for B, lanes 0-7 / 8-15 give an n8 tile's two 16-byte halves and
  // lanes 16-31 the next n8 tile's (b0, b1 of tiles j and j + 1).
  const unsigned a_lane = (warp_m * WM + (lane & 15)) * kRowBytes + (lane >> 4) * 16;
  const unsigned b_lane =
      BM * kRowBytes + (warp_n * WN + (lane & 7) + ((lane >> 4) << 3)) * kRowBytes +
      ((lane >> 3) & 1) * 16;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nsteps) load_stage(i, t_begin + i);
    cp_async_commit();
  }
  for (int t = 0; t < nsteps; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = t + kStages - 1;
    if (next < nsteps) load_stage(next % kStages, t_begin + next);
    cp_async_commit();
    const unsigned stage = ring + (t % kStages) * kStageBytes;
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      uint32_t af[MT][4], bf[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(af[i], stage + a_lane + i * 16 * kRowBytes + kk * 32);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b4[4];
        ldmatrix_x4(b4, stage + b_lane + j * 8 * kRowBytes + kk * 32);
        bf[j][0] = b4[0];
        bf[j][1] = b4[1];
        bf[j + 1][0] = b4[2];
        bf[j + 1][1] = b4[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // The int32 tile into shared memory (accumulator u of tile (i, j) at row
  // g (+8 for u >= 2), column 2 t4 + (u & 1)), and the epilogue's factors
  // of the block's BN columns.
  int* tile = reinterpret_cast<int*>(smem);
  float* fac = reinterpret_cast<float*>(smem + BM * kOutStride * 4);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int row = warp_m * WM + i * 16 + g;
      const int col = warp_n * WN + j * 8 + 2 * t4;
      *reinterpret_cast<int2*>(&tile[row * kOutStride + col]) =
          make_int2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<int2*>(&tile[(row + 8) * kOutStride + col]) =
          make_int2(acc[i][j][2], acc[i][j][3]);
    }
  if (tid < BN) {
    const int kk = k0 + tid;
    const bool in = kk < a.k;
    fac[tid] = in ? __fmul_rn(*a.x_scale, a.w_scale[kk]) : 0.f;
    fac[BN + tid] = (in && a.scale) ? a.scale[kk] : 1.f;
    fac[2 * BN + tid] = (in && a.shift) ? a.shift[kk] : 0.f;
    fac[3 * BN + tid] = (in && a.bias) ? a.bias[kk] : 0.f;
  }
  __syncthreads();

  constexpr int kVecs = BN / 4;                  // 16-byte groups of a row
  constexpr int kIters = BM * kVecs / kThreads;
  static_assert(BM * kVecs % kThreads == 0, "whole epilogue passes");
  if (a.splits > 1) {
    const int tile_id = blockIdx.y * gridDim.x + blockIdx.x;
    int* part = a.partial + static_cast<int64_t>(tile_id) * a.splits * BM * BN;
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int idx = tid + it * kThreads;
      const int row = idx / kVecs;
      const int v = idx % kVecs;
      *reinterpret_cast<int4*>(part + split * BM * BN + row * BN + v * 4) =
          *reinterpret_cast<const int4*>(&tile[row * kOutStride + v * 4]);
    }
    __threadfence();
    __syncthreads();
    __shared__ int last;
    if (tid == 0) {
      last = atomicAdd(a.counters + tile_id, 1) == a.splits - 1;
      if (last) a.counters[tile_id] = 0;  // ready for the next launch
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    // The other splits' partials into this thread's own words of the tile,
    // a whole pass of loads in flight per split.
    for (int z = 0; z < a.splits; ++z) {
      if (z == split) continue;
      int4 o[kIters];
#pragma unroll
      for (int it = 0; it < kIters; ++it) {
        const int idx = tid + it * kThreads;
        o[it] = __ldcg(reinterpret_cast<const int4*>(part + z * BM * BN + (idx / kVecs) * BN +
                                                     (idx % kVecs) * 4));
      }
#pragma unroll
      for (int it = 0; it < kIters; ++it) {
        const int idx = tid + it * kThreads;
        int4* t = reinterpret_cast<int4*>(&tile[(idx / kVecs) * kOutStride + (idx % kVecs) * 4]);
        int4 sum = *t;
        sum.x += o[it].x;
        sum.y += o[it].y;
        sum.z += o[it].z;
        sum.w += o[it].w;
        *t = sum;
      }
    }
  }

  // The epilogue in groups of kGroup passes: the group's residual loads
  // first (kGroup 16-byte loads in flight a thread), then its arithmetic and
  // stores.
  constexpr int kGroup = kIters < 4 ? kIters : 4;
  static_assert(kIters % kGroup == 0, "whole groups");
#pragma unroll
  for (int it0 = 0; it0 < kIters; it0 += kGroup) {
    float4 res[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int idx = tid + (it0 + u) * kThreads;
      const int64_t m = m0 + idx / kVecs;
      const int kk = k0 + (idx % kVecs) * 4;
      res[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (a.residual && m < a.m && kk < a.k)
        res[u] = __ldcs(reinterpret_cast<const float4*>(a.residual + m * a.k + kk));
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int idx = tid + (it0 + u) * kThreads;
      const int row = idx / kVecs;
      const int col = (idx % kVecs) * 4;
      const int64_t m = m0 + row;
      const int kk = k0 + col;
      if (m >= a.m || kk >= a.k) continue;  // K % 8 == 0: the group is whole
      const int4 sum = *reinterpret_cast<const int4*>(&tile[row * kOutStride + col]);
      float4 y;
      y.x = dequant_epilogue(a, sum.x, fac[col], fac[BN + col], fac[2 * BN + col],
                             fac[3 * BN + col], res[u].x);
      y.y = dequant_epilogue(a, sum.y, fac[col + 1], fac[BN + col + 1], fac[2 * BN + col + 1],
                             fac[3 * BN + col + 1], res[u].y);
      y.z = dequant_epilogue(a, sum.z, fac[col + 2], fac[BN + col + 2], fac[2 * BN + col + 2],
                             fac[3 * BN + col + 2], res[u].z);
      y.w = dequant_epilogue(a, sum.w, fac[col + 3], fac[BN + col + 3], fac[2 * BN + col + 3],
                             fac[3 * BN + col + 3], res[u].w);
      *reinterpret_cast<float4*>(a.out + m * a.k + kk) = y;
    }
  }
}

template <int BM, int BN, int BK, int WARPS_M>
int launch_ring(const Q8RingArgs& a, int stages, int smem, cudaStream_t stream) {
  using Shape = RingShape<BM, BN, BK>;
  const int total = a.r * a.s * a.c_steps;
  if (stages != Shape::kStages || smem != Shape::smem((total + a.splits - 1) / a.splits))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = conv2d_q8_kernel_ring<BM, BN, BK, WARPS_M>;
  // The attribute belongs to a device: granted once per device, to the
  // most any plan claims (the host cost of the call is paid once).
  constexpr int kMostSmem = Shape::smem(1 << 20);
  static bool granted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!granted[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMostSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    granted[dev] = true;
  }
  const dim3 grid(static_cast<unsigned>((a.m + BM - 1) / BM), (a.k + BN - 1) / BN, a.splits);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
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

// Launches K3's ring route on `stream` without synchronising and returns
// cudaGetLastError() (nonzero: refused, or an earlier fault pending).  w is
// the (R, S, K, C) layout of the weights; bm, bn, bk, stages, splits and
// smem come from kernels/conv2d_q8.py ring_plan, and a plan no instance
// was built for returns cudaErrorInvalidValue.  With splits > 1, partial
// holds (tiles, splits, bm, bn) int32 and counters (tiles,) int32 zeros.
// The caller checks shapes, dtypes, contiguity, alignment (x, w, residual
// 16-byte; C % 16 == 0, K % 8 == 0) and the int32 overflow bound.
extern "C" int repro_conv2d_q8_ring(const int8_t* x, const int8_t* w, const float* x_scale,
                                    const float* w_scale, const float* scale,
                                    const float* shift, const float* bias,
                                    const float* residual, float* out, int* partial,
                                    int* counters, int n, int h, int wd, int c, int k, int r,
                                    int s, int stride, int pad, int relu, int bm, int bn,
                                    int bk, int stages, int splits, int smem, void* stream) {
  Q8RingArgs a;
  a.x = x;
  a.w = w;
  a.x_scale = x_scale;
  a.w_scale = w_scale;
  a.scale = scale;
  a.shift = shift;
  a.bias = bias;
  a.residual = residual;
  a.out = out;
  a.partial = partial;
  a.counters = counters;
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
  a.splits = splits;
  a.c_steps = (c + bk - 1) / bk;
  if (a.m <= 0 || k <= 0 || c % 16 || k % 8 || splits < 1 || splits > 65535 ||
      (splits > 1 && (partial == nullptr || counters == nullptr)) ||
      splits > r * s * a.c_steps)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bm == 128 && bn == 64 && bk == 128) return launch_ring<128, 64, 128, 4>(a, stages, smem, st);
  if (bm == 128 && bn == 64 && bk == 64) return launch_ring<128, 64, 64, 4>(a, stages, smem, st);
  if (bm == 64 && bn == 64 && bk == 128) return launch_ring<64, 64, 128, 2>(a, stages, smem, st);
  if (bm == 64 && bn == 64 && bk == 64) return launch_ring<64, 64, 64, 2>(a, stages, smem, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
