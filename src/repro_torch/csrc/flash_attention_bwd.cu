// K7's backward on Hopper: dq, dk and dv of blocked attention.
//
// Replaces no Pallas kernel: the JAX package's Pallas attention has no
// custom_vjp, so its training step differentiates ref.attention_chunked
// with XLA's autodiff (repro/train/step.py, on the "xla" path).  This is
// that gradient, written by hand: for q (B,Hq,L,Dh), k and v (B,Hkv,L,Dh),
// the forward's output o and the output gradient dout, with query head h
// reading KV head h / (Hq/Hkv),
//   P  = softmax(scale * q k^T [causal, the forward's -1e30 mask]),
//   dv = P^T dout,  dS = P o (dout v^T - delta),  delta = rowsum(dout o),
//   dq = scale dS k,  dk = scale dS^T q,
// summed over the query heads of each KV head (GQA), in f32, written once
// in the inputs' dtype (f32 or bf16).  Built with nvcc for sm_90a and bound
// through the plain C function at the bottom (ctypes; see
// repro_torch/kernels/_build.py).
//
// What bounds it on an H100: about 5 Dh L^2 FLOP per query head when
// causal (twice that without the mask): a recomputed S, dP = dout v^T, the
// dv and dk products, and dq; far above the ridge, so the arithmetic rate:
// 989 TFLOP/s on the bf16 tensor cores, 67 TFLOP/s f32 on the SIMT cores.
// No route uses atomics: two calls give the same bits.  Two routes, chosen
// in the wrapper (kernels/attention.route_bwd, the forward's rule):
//
// The wgmma route, bf16 with Dh 64 or 128, contiguous and 16-byte aligned:
// the forward's TMA + wgmma skeleton (flash_attention.cu) with the
// backward's products, every one on the bf16 tensor cores with f32 sums,
// and the rows' log-sum-exp that the forward saved (lse), so no kernel
// rebuilds the softmax's max and sum (without it the dq kernel does, in a
// first pass over the key blocks: a template flag, not a fallback).
//
// flash_attention_bwd_dq_kernel_wgmma, one block per (b*Hq + h, 64-query
// tile), heaviest causal tiles first; one consumer warpgroup and a producer
// warp whose one thread loads the q and dout tiles once and keeps TMA loads
// of k and v blocks (64 keys) in flight in a 2-stage ring on mbarriers, to
// the diagonal when causal:
//   * the prologue computes delta = rowsum(dout o) (the 4 lanes of a
//     quad, one row) while the tiles land, and writes it for the dk/dv
//     kernel;
//   * S = Q K^T and dP = dout V^T (wgmma m64n64k16, all four K-major);
//     P = exp2(scale log2(e) s - lse log2(e)), 0 where masked; dS =
//     P (dP - delta) rounded to bf16 stays in registers as the A fragment
//     (the S fragment, pair for pair, as the forward's P); dQ += dS K with
//     k read MN-major through the transpose bit (m64n128k16 or m64n64k16);
//   * dq = scale * acc, once, in bf16 through the q tile and TMA stores.
//   154 registers at Dh 128 and 122 at Dh 64, no spill (-Xptxas -v); two
//   blocks an SM (97 KB of shared memory at Dh 128).
//
// flash_attention_bwd_dkdv_kernel_wgmma, one block per (key block of 64,
// split, b*Hkv + g), key block 0 (the heaviest when causal) first: k and v
// loaded once; the ring streams the (q, dout) tiles of QB queries of the
// group's query heads (the split's share), from the diagonal on when
// causal, and the producer warp's lanes put the step's lse and delta in
// shared memory beside them (read from device memory by the consumer,
// they held 32 registers and put their latency on every step's chain).
// Per step:
//   * S^T = K Q^T and dP^T = V dout^T (k, v as A from shared memory, q and
//     dout as K-major B);
//   * P^T = exp2(...), 0 where masked (causal, a key or a query >= L);
//     dV += P^T dout (P^T in registers as A, dout MN-major);
//   * dS^T = P^T (dP^T - delta); dK += dS^T Q (dS^T in registers, q
//     MN-major).  One shared-memory tile of q and one of dout serve as both
//     K-major and MN-major operands.
//   dk and dv (64 keys x Dh f32) stay in registers over the whole loop:
//   128 a thread at Dh 128.  QB is fixed by Dh: 64 at Dh 128 (235
//   registers, no spill; one block an SM; at QB 32 ptxas spilled 144 bytes
//   at the 2-blocks bound) and 32 at Dh 64 (130 registers, no spill; QB 64
//   took 179 and was slower), from the times of every (splits, QB) that
//   PERF.md records.  With
//   splits > 1 each block writes f32 partial dk and dv and
//   flash_attention_bwd_split_sum_kernel adds the splits in a fixed order
//   (the GQA sum of a causal grid that is one uneven wave spread over more
//   blocks); with 1 the block writes dk = scale * dk and dv in bf16 through
//   the k and v tiles and TMA stores.
//
// The SIMT route: f32 (held to 1e-5) and bf16 off that rule (Dh 16), f32
// FMA on the CUDA cores, the first kernels of this file:
//
// flash_attention_bwd_dq_kernel, one block of 256 threads per (b*Hq + h,
// 64-query block), heaviest causal blocks first:
//   * stages scale * q and dout transposed (f32) and computes each row's
//     delta = sum_d dout o (four threads a row, a shuffle);
//   * pass 1 walks the 64-key blocks (to the diagonal when causal) with the
//     forward's online max and sum, a thread owning 4 rows x 4 keys of S,
//     the 16 threads of a row on one half-warp: lse = m + log(l), written
//     to the wrapper's f32 scratch with delta;
//   * pass 2 walks them again: S and dP = dout v^T from k and v staged
//     transposed, P = exp(S - lse) (0 where masked), dS = P (dP - delta)
//     through shared memory into dq += dS k from k staged by rows; dq is
//     written once, times scale.
//
// flash_attention_bwd_dkdv_kernel, one block of 256 threads per (b*Hkv + g,
// 64-key block), runs after it:
//   * stages k and v transposed once; loops over the Hq/Hkv query heads of
//     the group and, per head, over 32-query steps from the diagonal on
//     when causal; a thread owns 4 keys x 2 queries of S^T and dP^T and 4
//     keys x Dh/16 features of dk and dv, kept in registers over the
//     whole loop;
//   * per step: q (scaled) and dout transposed and by rows, the step's lse
//     and delta; P^T and dS^T through shared memory into dv += P^T dout
//     and dk += dS^T q; the GQA sum stays inside the block, and each dk and
//     dv tile is written once.
//
// Query and key tails are masked (keys >= L and queries >= L give P = 0,
// rows >= L never stored), so any L >= 1 is legal.  Dh is a template
// parameter: 16, 64 or 128.  Offsets are 64-bit.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"  // TMA, mbarriers, wgmma, the tensor-map encoder

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;              // queries per block of the dq kernel
constexpr int kBK = 64;              // keys per block, both kernels
constexpr int kBQ2 = 32;             // queries per step of the dk/dv kernel
constexpr int kPStride = kBK + 4;    // row stride of dS in the dq kernel
constexpr int kTStride = kBQ2 + 4;   // row stride of P^T and dS^T
constexpr float kNeg = -1e30f;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* lse;    // (B*Hq, L) scratch
  float* delta;  // (B*Hq, L) scratch
  int b, hq, hkv, l;
  float scale;
  int causal;
};

__device__ __forceinline__ void load4(const float* p, int n, float v[4]) {
  if (n >= 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = c < n ? p[c] : 0.f;
  }
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, int n, float v[4]) {
  if (n >= 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = c < n ? __bfloat162float(p[c]) : 0.f;
  }
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  uint2 u;
  *reinterpret_cast<__nv_bfloat162*>(&u.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&u.y) = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// VW consecutive floats of shared memory (VW = 1, 2 or 4).
template <int VW>
__device__ __forceinline__ void lds(const float* p, float v[VW]) {
  if constexpr (VW == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else if constexpr (VW == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x; v[1] = f.y;
  } else {
    v[0] = *p;
  }
}

// Rows [row0, row0 + R) of a (L, D) matrix, transposed into dst[D][R] as
// f32 times `mul`; rows >= L become zeros.
template <typename T, int D, int R>
__device__ __forceinline__ void stage_transposed(float* dst, const T* src, int row0, int l,
                                                 float mul) {
  const int i = threadIdx.x % R;
  const bool in = row0 + i < l;
  for (int dq = threadIdx.x / R; dq < D / 4; dq += kThreads / R) {
    float x[4];
    load4(src + static_cast<int64_t>(row0 + i) * D + dq * 4, in ? 4 : 0, x);
#pragma unroll
    for (int c = 0; c < 4; ++c) dst[(dq * 4 + c) * R + i] = x[c] * mul;
  }
}

// Rows [row0, row0 + R) of a (L, D) matrix into dst[R][D] as f32, rows >= L
// as zeros.
template <typename T, int D, int R>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int row0, int l) {
  for (int e = threadIdx.x; e < R * D / 4; e += kThreads) {
    const int j = e / (D / 4), dq = e % (D / 4);
    float x[4];
    load4(src + static_cast<int64_t>(row0 + j) * D + dq * 4, row0 + j < l ? 4 : 0, x);
    store4(dst + j * D + dq * 4, x);
  }
}

// A thread's 4 rows x (D/16 features) of a (rows, D) result, in q's dtype,
// times `mul`; rows >= L are not stored.
template <typename T, int D, int VW, int kG>
__device__ __forceinline__ void store_rows(T* out, float acc[4][VW * kG], int row0,
                                           int l, float mul) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = row0 + ty * 4 + r;
    if (row >= l) continue;
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      T* dst = out + static_cast<int64_t>(row) * D + (g * 16 + tx) * VW;
      float o[4];
#pragma unroll
      for (int c = 0; c < VW; ++c) o[c] = acc[r][g * VW + c] * mul;
      if constexpr (VW == 4) {
        store4(dst, o);
      } else {
#pragma unroll
        for (int c = 0; c < VW; ++c) store1(dst + c, o[c]);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dq_kernel(const BwdArgs a) {
  static_assert(D % 16 == 0 && D <= 128, "16 threads share a row's D features");
  constexpr int VW = D >= 64 ? 4 : D / 16;
  constexpr int kG = D / (16 * VW);
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [D][kBQ], scale * q, transposed
  float* dot = qt + D * kBQ;                     // [D][kBQ], dout transposed
  float* kt = dot + D * kBQ;                     // [D][kBK], k transposed
  float* vt = kt + D * kBK;                      // [D][kBK], v transposed
  float* ks = vt + D * kBK;                      // [kBK][D], k by rows
  float* ds = ks + kBK * D;                      // [kBQ][kPStride]
  __shared__ float row_lse[kBQ], row_delta[kBQ];

  const int tx = threadIdx.x % 16;  // keys tx*4.. of S; features (16g + tx)*VW.. of dq
  const int ty = threadIdx.x / 16;  // query rows ty*4..ty*4+3
  const int l = a.l;
  const int nqb = (l + kBQ - 1) / kBQ;
  const int qb = nqb - 1 - static_cast<int>(blockIdx.x);  // heaviest first
  const int q0 = qb * kBQ;
  const int64_t bh = blockIdx.y;
  const int64_t kvh = bh / (a.hq / a.hkv);
  const T* q = static_cast<const T*>(a.q) + bh * l * D;
  const T* o = static_cast<const T*>(a.o) + bh * l * D;
  const T* dout = static_cast<const T*>(a.dout) + bh * l * D;
  const T* k = static_cast<const T*>(a.k) + kvh * l * D;
  const T* v = static_cast<const T*>(a.v) + kvh * l * D;

  stage_transposed<T, D, kBQ>(qt, q, q0, l, a.scale);
  stage_transposed<T, D, kBQ>(dot, dout, q0, l, 1.f);
  {  // delta = sum_d dout o, four threads a row
    const int i = threadIdx.x / 4, part = threadIdx.x % 4;
    float sum = 0.f;
    if (q0 + i < l) {
      for (int d = part * 4; d < D; d += 16) {
        float x[4], y[4];
        load4(dout + static_cast<int64_t>(q0 + i) * D + d, 4, x);
        load4(o + static_cast<int64_t>(q0 + i) * D + d, 4, y);
#pragma unroll
        for (int c = 0; c < 4; ++c) sum = fmaf(x[c], y[c], sum);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (part == 0) {
      row_delta[i] = sum;
      if (q0 + i < l) a.delta[bh * l + q0 + i] = sum;
    }
  }

  const int nkb = (l + kBK - 1) / kBK;
  const int kb_end = a.causal ? min(nkb, qb + 1) : nkb;

  // pass 1: each row's log-sum-exp over its unmasked keys
  float m[4], lsum[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNeg;
    lsum[r] = 0.f;
  }
  for (int kb = 0; kb < kb_end; ++kb) {
    const int k0 = kb * kBK;
    stage_transposed<T, D, kBK>(kt, k, k0, l, 1.f);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(qt + d * kBQ + ty * 4);
      const float4 kk = *reinterpret_cast<const float4*>(kt + d * kBK + tx * 4);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = q0 + ty * 4 + r;
      bool ok[4];
      float mx = kNeg;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = k0 + tx * 4 + c;
        ok[c] = kj < l && (!a.causal || kj <= qi);
        if (ok[c]) mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_cur = fmaxf(m[r], mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) sum += ok[c] ? expf(s[r][c] - m_cur) : 0.f;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      lsum[r] = lsum[r] * expf(m[r] - m_cur) + sum;
      m[r] = m_cur;
    }
    __syncthreads();  // before the next block overwrites kt
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty * 4 + r;
    const float lse = m[r] + logf(lsum[r]);
    if (tx == 0) {
      row_lse[i] = lse;
      if (q0 + i < l) a.lse[bh * l + q0 + i] = lse;
    }
  }
  __syncthreads();
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    lse_r[r] = row_lse[ty * 4 + r];
    delta_r[r] = row_delta[ty * 4 + r];
  }

  // pass 2: dS = P (dP - delta), dq += dS k
  float acc[4][VW * kG];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < VW * kG; ++c) acc[r][c] = 0.f;
  for (int kb = 0; kb < kb_end; ++kb) {
    const int k0 = kb * kBK;
    stage_transposed<T, D, kBK>(kt, k, k0, l, 1.f);
    stage_transposed<T, D, kBK>(vt, v, k0, l, 1.f);
    stage_rows<T, D, kBK>(ks, k, k0, l);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(qt + d * kBQ + ty * 4);
      const float4 da = *reinterpret_cast<const float4*>(dot + d * kBQ + ty * 4);
      const float4 kk = *reinterpret_cast<const float4*>(kt + d * kBK + tx * 4);
      const float4 vv = *reinterpret_cast<const float4*>(vt + d * kBK + tx * 4);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float dv[4] = {da.x, da.y, da.z, da.w};
      const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
      const float vc[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
          dp[r][c] = fmaf(dv[r], vc[c], dp[r][c]);
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = q0 + ty * 4 + r;
      float dsv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = k0 + tx * 4 + c;
        const bool ok = kj < l && (!a.causal || kj <= qi);
        const float p = ok ? expf(s[r][c] - lse_r[r]) : 0.f;
        dsv[c] = p * (dp[r][c] - delta_r[r]);
      }
      store4(ds + (ty * 4 + r) * kPStride + tx * 4, dsv);
    }
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float sr[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 sv = *reinterpret_cast<const float4*>(ds + (ty * 4 + r) * kPStride + j);
        sr[r][0] = sv.x; sr[r][1] = sv.y; sr[r][2] = sv.z; sr[r][3] = sv.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          float kc[VW];
          lds<VW>(ks + (j + jj) * D + (g * 16 + tx) * VW, kc);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < VW; ++c)
              acc[r][g * VW + c] = fmaf(sr[r][jj], kc[c], acc[r][g * VW + c]);
        }
      }
    }
    __syncthreads();  // before the next block overwrites kt, vt, ks, ds
  }
  store_rows<T, D, VW, kG>(static_cast<T*>(a.dq) + bh * l * D, acc, q0, l, a.scale);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dkdv_kernel(const BwdArgs a) {
  static_assert(D % 16 == 0 && D <= 128, "16 threads share a row's D features");
  constexpr int VW = D >= 64 ? 4 : D / 16;
  constexpr int kG = D / (16 * VW);
  constexpr int QW = kBQ2 / 16;  // queries per thread of S^T
  extern __shared__ float4 smem4[];
  float* kt = reinterpret_cast<float*>(smem4);  // [D][kBK], k transposed
  float* vt = kt + D * kBK;                      // [D][kBK], v transposed
  float* qt = vt + D * kBK;                      // [D][kBQ2], scale * q transposed
  float* dot = qt + D * kBQ2;                    // [D][kBQ2], dout transposed
  float* qs = dot + D * kBQ2;                    // [kBQ2][D], q by rows
  float* dos = qs + kBQ2 * D;                    // [kBQ2][D], dout by rows
  float* pt = dos + kBQ2 * D;                    // [kBK][kTStride], P^T
  float* dst = pt + kBK * kTStride;              // [kBK][kTStride], dS^T
  __shared__ float row_lse[kBQ2], row_delta[kBQ2];

  const int tx = threadIdx.x % 16;  // queries tx*QW.. of S^T; features (16g + tx)*VW..
  const int ty = threadIdx.x / 16;  // keys ty*4..ty*4+3
  const int l = a.l;
  const int k0 = static_cast<int>(blockIdx.x) * kBK;  // causal: heaviest first
  const int64_t bkv = blockIdx.y;                       // b * Hkv + g
  const int rep = a.hq / a.hkv;
  const int64_t bi = bkv / a.hkv, g = bkv % a.hkv;
  const T* k = static_cast<const T*>(a.k) + bkv * l * D;
  const T* v = static_cast<const T*>(a.v) + bkv * l * D;

  stage_transposed<T, D, kBK>(kt, k, k0, l, 1.f);
  stage_transposed<T, D, kBK>(vt, v, k0, l, 1.f);

  float dk[4][VW * kG], dv[4][VW * kG];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < VW * kG; ++c) dk[j][c] = dv[j][c] = 0.f;

  const int nqb = (l + kBQ2 - 1) / kBQ2;
  const int qb0 = a.causal ? k0 / kBQ2 : 0;
  for (int r = 0; r < rep; ++r) {
    const int64_t bh = bi * a.hq + g * rep + r;
    const T* q = static_cast<const T*>(a.q) + bh * l * D;
    const T* dout = static_cast<const T*>(a.dout) + bh * l * D;
    const float* lse = a.lse + bh * l;
    const float* delta = a.delta + bh * l;
    for (int qb = qb0; qb < nqb; ++qb) {
      const int q0 = qb * kBQ2;
      __syncthreads();  // the last step's reads of qt, dot, qs, dos, pt, dst are done
      stage_transposed<T, D, kBQ2>(qt, q, q0, l, a.scale);
      stage_transposed<T, D, kBQ2>(dot, dout, q0, l, 1.f);
      stage_rows<T, D, kBQ2>(qs, q, q0, l);
      stage_rows<T, D, kBQ2>(dos, dout, q0, l);
      if (threadIdx.x < kBQ2) {
        const int i = q0 + threadIdx.x;
        row_lse[threadIdx.x] = i < l ? lse[i] : 0.f;
        row_delta[threadIdx.x] = i < l ? delta[i] : 0.f;
      }
      __syncthreads();
      float s[4][QW], dp[4][QW];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < QW; ++c) s[j][c] = dp[j][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float4 kk = *reinterpret_cast<const float4*>(kt + d * kBK + ty * 4);
        const float4 vv = *reinterpret_cast<const float4*>(vt + d * kBK + ty * 4);
        float qa[QW], da[QW];
        lds<QW>(qt + d * kBQ2 + tx * QW, qa);
        lds<QW>(dot + d * kBQ2 + tx * QW, da);
        const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
        const float vc[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < QW; ++c) {
            s[j][c] = fmaf(kv[j], qa[c], s[j][c]);
            dp[j][c] = fmaf(vc[j], da[c], dp[j][c]);
          }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + ty * 4 + j;
#pragma unroll
        for (int c = 0; c < QW; ++c) {
          const int i = tx * QW + c, qi = q0 + i;
          const bool ok = kj < l && qi < l && (!a.causal || kj <= qi);
          const float p = ok ? expf(s[j][c] - row_lse[i]) : 0.f;
          pt[(ty * 4 + j) * kTStride + i] = p;
          dst[(ty * 4 + j) * kTStride + i] = p * (dp[j][c] - row_delta[i]);
        }
      }
      __syncthreads();
      // dv += P^T dout, dk += dS^T q
#pragma unroll 2
      for (int i = 0; i < kBQ2; i += 4) {
        float pr[4][4], sr[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 pv = *reinterpret_cast<const float4*>(pt + (ty * 4 + j) * kTStride + i);
          const float4 sv = *reinterpret_cast<const float4*>(dst + (ty * 4 + j) * kTStride + i);
          pr[j][0] = pv.x; pr[j][1] = pv.y; pr[j][2] = pv.z; pr[j][3] = pv.w;
          sr[j][0] = sv.x; sr[j][1] = sv.y; sr[j][2] = sv.z; sr[j][3] = sv.w;
        }
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
          for (int gg = 0; gg < kG; ++gg) {
            float oc[VW], qc[VW];
            lds<VW>(dos + (i + ii) * D + (gg * 16 + tx) * VW, oc);
            lds<VW>(qs + (i + ii) * D + (gg * 16 + tx) * VW, qc);
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int c = 0; c < VW; ++c) {
                dv[j][gg * VW + c] = fmaf(pr[j][ii], oc[c], dv[j][gg * VW + c]);
                dk[j][gg * VW + c] = fmaf(sr[j][ii], qc[c], dk[j][gg * VW + c]);
              }
          }
        }
      }
    }
  }
  store_rows<T, D, VW, kG>(static_cast<T*>(a.dk) + bkv * l * D, dk, k0, l, a.scale);
  store_rows<T, D, VW, kG>(static_cast<T*>(a.dv) + bkv * l * D, dv, k0, l, 1.f);
}

template <typename T, int D>
int launch(const BwdArgs& a, cudaStream_t stream) {
  constexpr size_t smem_dq =
      static_cast<size_t>(4 * D * kBQ + kBK * D + kBQ * kPStride) * sizeof(float);
  constexpr size_t smem_dkdv =
      static_cast<size_t>(2 * D * kBK + 4 * D * kBQ2 + 2 * kBK * kTStride) * sizeof(float);
  // per call: the attribute belongs to the current device
  cudaError_t e = cudaFuncSetAttribute(flash_attention_bwd_dq_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem_dq));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(flash_attention_bwd_dkdv_kernel<T, D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem_dkdv));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid_dq((a.l + kBQ - 1) / kBQ, a.b * a.hq);
  flash_attention_bwd_dq_kernel<T, D><<<grid_dq, kThreads, smem_dq, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid_dkdv((a.l + kBK - 1) / kBK, a.b * a.hkv);
  flash_attention_bwd_dkdv_kernel<T, D><<<grid_dkdv, kThreads, smem_dkdv, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---- the bf16 route: TMA + wgmma ----------------------------------------

namespace wg {

using namespace hopper;

constexpr int kStages = 2;             // the ring of both kernels
constexpr int kBox = 64 * 128;         // one 64-row x 64-column bf16 box, 8 KB
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&b);
}

// The dq kernel: 64 queries of one (batch, query head) a block, key blocks
// of 64.
template <int D>
struct DqCfg {
  static constexpr int kBoxes = D / 64;
  static constexpr int kTile = 64 * D * 2;       // 64 rows of q, dout, k or v
  static constexpr int kStageBytes = 2 * kTile;  // k, then v
  static constexpr int kSmem = 2 * kTile + kStages * kStageBytes + 1024;  // + 1 KB alignment
  static constexpr int kThreads = 128 + 32;      // one consumer warpgroup + a producer warp
};

struct DqArgs {
  const void* o;
  const void* dout;
  float* lse;    // (B*Hq, L): read when given, else written by pass 1
  float* delta;  // (B*Hq, L): written for the dk/dv kernel
  int l, hq, hkv, nqb, bh;
  float scale, scale_log2;
  int causal;
};

// One block: 64 queries of one (batch, query head); block i takes query
// tile nqb - 1 - i / bh of head i % bh (heaviest causal tiles first).
// kLseGiven: read each row's log-sum-exp (the forward's); else rebuild it
// in a first pass over the key blocks, for which the ring streams k alone.
template <int D, bool kLseGiven>
__global__ void __launch_bounds__(DqCfg<D>::kThreads, 2)
flash_attention_bwd_dq_kernel_wgmma(const __grid_constant__ CUtensorMap map_q,
                                    const __grid_constant__ CUtensorMap map_k,
                                    const __grid_constant__ CUtensorMap map_v,
                                    const __grid_constant__ CUtensorMap map_do,
                                    const __grid_constant__ CUtensorMap map_dq,
                                    const DqArgs a) {
  using C = DqCfg<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full;
  __shared__ __align__(8) uint64_t full[kStages];   // the stage's k (and v) landed
  __shared__ __align__(8) uint64_t empty[kStages];  // the consumer is done with it
  uint8_t* qs = align1024(smem_raw);
  uint8_t* dos = qs + C::kTile;
  uint8_t* ring = dos + C::kTile;
  const int bh = static_cast<int>(blockIdx.x) % a.bh;
  const int q0 = (a.nqb - 1 - static_cast<int>(blockIdx.x) / a.bh) * 64;
  const int kvh = bh / (a.hq / a.hkv);
  const int nkb = (a.l + 63) / 64;
  const int kb_end = a.causal ? min(nkb, q0 / 64 + 1) : nkb;
  const int n_it = (kLseGiven ? 1 : 2) * kb_end;

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // the producer warp: one thread keeps the ring full
    if (threadIdx.x == 128) {
      mbar_expect_tx(&q_full, 2 * C::kTile);
#pragma unroll
      for (int x = 0; x < C::kBoxes; ++x) {
        tma_load_3d(qs + x * kBox, &map_q, &q_full, x * 64, q0, bh);
        tma_load_3d(dos + x * kBox, &map_do, &q_full, x * 64, q0, bh);
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kStages;
        const bool with_v = it >= n_it - kb_end;  // pass 1 reads k alone
        const int kb = with_v ? it - (n_it - kb_end) : it;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);  // the first round passes
        uint8_t* ks = ring + s * C::kStageBytes;
        mbar_expect_tx(&full[s], with_v ? 2 * C::kTile : C::kTile);
#pragma unroll
        for (int x = 0; x < C::kBoxes; ++x) {
          tma_load_3d(ks + x * kBox, &map_k, &full[s], x * 64, kb * 64, kvh);
          if (with_v)
            tma_load_3d(ks + C::kTile + x * kBox, &map_v, &full[s], x * 64, kb * 64, kvh);
        }
      }
    }
    return;
  }

  // the consumer warpgroup: this thread's rows are row_a and row_a + 8
  const int t = threadIdx.x;
  const int r0 = (t / 32) * 16 + (t % 32) / 4;
  const int row_a = q0 + r0;
  const int64_t base = static_cast<int64_t>(bh) * a.l;
  // delta = rowsum(dout o) in f32 while the loads fly: the 4 lanes of a
  // quad share a row, D/4 columns each
  float delta[2], lse2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_a + 8 * h;
    float sum = 0.f;
    if (row < a.l) {
      const int64_t off = (base + row) * D + (t % 4) * (D / 4);
      const uint4* x =
          reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(a.dout) + off);
      const uint4* y = reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(a.o) + off);
#pragma unroll
      for (int c = 0; c < D / 32; ++c) {
        const uint4 xv = x[c], yv = y[c];
        const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&xv);
        const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&yv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 fx = __bfloat1622float2(xp[e]), fy = __bfloat1622float2(yp[e]);
          sum = fmaf(fx.x, fy.x, sum);
          sum = fmaf(fx.y, fy.y, sum);
        }
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    delta[h] = sum;
    if (t % 4 == 0 && row < a.l) a.delta[base + row] = sum;
    if constexpr (kLseGiven) lse2[h] = row < a.l ? a.lse[base + row] * kLog2e : 0.f;
  }
  const uint32_t q_addr = smem_u32(qs);
  const uint32_t do_addr = smem_u32(dos);
  mbar_wait(&q_full, 0);

  int it = 0;
  if constexpr (!kLseGiven) {
    // pass 1: each row's log-sum-exp by the forward's online max and sum
    float m[2] = {-1e30f, -1e30f}, lsum[2] = {0.f, 0.f};
    for (int kb = 0; kb < kb_end; ++kb, ++it) {
      const int s = it % kStages;
      const int k0 = kb * 64;
      mbar_wait(&full[s], (it / kStages) & 1);
      const uint32_t k_addr = smem_u32(ring + s * C::kStageBytes);
      float sc[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
        wgmma_bf16_kk(sc, desc_sw128(q_addr + off, 16, 1024), desc_sw128(k_addr + off, 16, 1024),
                      kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      if (t == 0) mbar_arrive(&empty[s]);
      const bool edge = k0 + 64 > a.l || (a.causal && k0 + 63 > q0);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float x = sc[4 * j + 2 * h + c] * a.scale_log2;
            if (edge) {
              const int key = k0 + 8 * j + 2 * (t % 4) + c;
              if (key >= a.l || (a.causal && key > row_a + 8 * h)) x = __int_as_float(0xff800000);
            }
            sc[4 * j + 2 * h + c] = x;
            mx[h] = fmaxf(mx[h], x);
          }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          rs += exp2f(sc[4 * j + 2 * h] - mx[h]) + exp2f(sc[4 * j + 2 * h + 1] - mx[h]);
        lsum[h] = lsum[h] * exp2f(m[h] - mx[h]) + rs;
        m[h] = mx[h];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 1);
      lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 2);
      lse2[h] = m[h] + log2f(lsum[h]);
      if (t % 4 == 0 && row_a + 8 * h < a.l) a.lse[base + row_a + 8 * h] = lse2[h] * kLn2;
    }
  }

  // pass 2: S = Q K^T, dP = dout V^T, dS = P (dP - delta), dQ += dS K
  float acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
  for (int kb = 0; kb < kb_end; ++kb, ++it) {
    const int s = it % kStages;
    const int k0 = kb * 64;
    mbar_wait(&full[s], (it / kStages) & 1);
    const uint32_t k_addr = smem_u32(ring + s * C::kStageBytes);
    const uint32_t v_addr = k_addr + C::kTile;
    float sc[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
      wgmma_bf16_kk(sc, desc_sw128(q_addr + off, 16, 1024), desc_sw128(k_addr + off, 16, 1024),
                    kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
      wgmma_bf16_kk(dp, desc_sw128(do_addr + off, 16, 1024), desc_sw128(v_addr + off, 16, 1024),
                    kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);
    // P = exp(scale s - lse), 0 where masked (causal, or a key >= L)
    const bool edge = k0 + 64 > a.l || (a.causal && k0 + 63 > q0);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float p = exp2f(sc[4 * j + 2 * h + c] * a.scale_log2 - lse2[h]);
          if (edge) {
            const int key = k0 + 8 * j + 2 * (t % 4) + c;
            if (key >= a.l || (a.causal && key > row_a + 8 * h)) p = 0.f;
          }
          sc[4 * j + 2 * h + c] = p;
        }
    wgmma_wait<0>();
    fence_regs(dp);
    // dS in bf16: the S fragment is the A fragment of dS K, pair for pair
    uint32_t pa[16];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        pa[2 * j + h] = pack_bf16(sc[4 * j + 2 * h] * (dp[4 * j + 2 * h] - delta[h]),
                                  sc[4 * j + 2 * h + 1] * (dp[4 * j + 2 * h + 1] - delta[h]));
    // dQ += dS K: k read MN-major through the transpose bit
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t frag[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
      wgmma_bf16_rs(acc, frag, desc_sw128(k_addr + kk * 16 * 128, kBox, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
    if (t == 0) mbar_arrive(&empty[s]);
  }

  // dq = scale * acc in bf16, through the q tile (no wgmma reads it now) in
  // the 128-byte swizzle, and TMA stores that drop rows >= L
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(qs + sw128_at(r0 + 8 * h, j * 8 + (t % 4) * 2, kBox)) =
          pack_bf16(acc[4 * j + 2 * h] * a.scale, acc[4 * j + 2 * h + 1] * a.scale);
  fence_async_smem();
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
  if (t == 0) {
#pragma unroll
    for (int x = 0; x < C::kBoxes; ++x) tma_store_3d(&map_dq, qs + x * kBox, x * 64, q0, bh);
    tma_store_wait();
  }
}

// The dk/dv kernel: 64 keys of one (batch, KV head) a block, the group's
// query heads (a split's share of them) in steps of kQB queries.
template <int D>
struct KvCfg {
  static constexpr int kQB = D == 128 ? 64 : 32;  // queries a step
  static constexpr int kBoxes = D / 64;
  static constexpr int kKV = 64 * D * 2;         // k or v: 64 keys
  static constexpr int kQ = kQB * D * 2;         // q or dout: kQB queries
  static constexpr int kQBox = kQB * 128;        // one 64-column box of it
  static constexpr int kStageBytes = 2 * kQ;     // q, then dout
  static constexpr int kSmem = 2 * kKV + kStages * kStageBytes + 1024;
  static constexpr int kThreads = 128 + 32;
  static constexpr int kBlocksPerSm = kQB == 32 ? 2 : 1;  // what the registers allow
};

struct KvArgs {
  const float* lse;    // (B*Hq, L)
  const float* delta;  // (B*Hq, L)
  float* part;         // splits > 1: (splits, 2, B*Hkv, L, D) f32 partial dk, dv
  int l, hq, hkv, bkv, splits;
  float scale, scale_log2;
  int causal;
};

// One block: 64 keys of (batch, KV head) g = i % bkv and the split sp of
// its query heads; block i takes key block i / (bkv * splits), so key block
// 0, the heaviest when causal, goes first.
template <int D>
__global__ void __launch_bounds__(KvCfg<D>::kThreads, KvCfg<D>::kBlocksPerSm)
flash_attention_bwd_dkdv_kernel_wgmma(const __grid_constant__ CUtensorMap map_q,
                                      const __grid_constant__ CUtensorMap map_k,
                                      const __grid_constant__ CUtensorMap map_v,
                                      const __grid_constant__ CUtensorMap map_do,
                                      const __grid_constant__ CUtensorMap map_dk,
                                      const __grid_constant__ CUtensorMap map_dv,
                                      const KvArgs a) {
  using C = KvCfg<D>;
  constexpr int QB = C::kQB;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t kv_full;
  __shared__ __align__(8) uint64_t full[kStages];   // the stage's q and dout landed
  __shared__ __align__(8) uint64_t empty[kStages];  // the consumer is done with it
  __shared__ float lse_s[kStages][QB];  // the stage's rows' lse * log2(e)
  __shared__ float dl_s[kStages][QB];   // and delta; 0 past L
  uint8_t* ks = align1024(smem_raw);
  uint8_t* vs = ks + C::kKV;
  uint8_t* ring = vs + C::kKV;
  const int i = static_cast<int>(blockIdx.x);
  const int g = i % a.bkv;
  const int sp = (i / a.bkv) % a.splits;
  const int k0 = (i / (a.bkv * a.splits)) * 64;
  const int rep = a.hq / a.hkv;
  const int per = rep / a.splits;             // query heads of this block
  const int bh0 = (g / a.hkv) * a.hq + (g % a.hkv) * rep + sp * per;
  const int nqt = (a.l + QB - 1) / QB;
  const int qt0 = a.causal ? k0 / QB : 0;     // causal: from the diagonal on
  const int steps = nqt - qt0;                // a head's
  const int n_it = per * steps;

  if (threadIdx.x == 0) {
    mbar_init(&kv_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // the producer warp: lane 0 keeps the ring full
    const int lane = threadIdx.x - 128;
    if (lane == 0) {
      mbar_expect_tx(&kv_full, 2 * C::kKV);
#pragma unroll
      for (int x = 0; x < C::kBoxes; ++x) {
        tma_load_3d(ks + x * kBox, &map_k, &kv_full, x * 64, k0, g);
        tma_load_3d(vs + x * kBox, &map_v, &kv_full, x * 64, k0, g);
      }
    }
    for (int it = 0; it < n_it; ++it) {
      const int s = it % kStages;
      const int bh = bh0 + it / steps;
      const int q0 = (qt0 + it % steps) * QB;
      mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
      // the step's lse and delta through shared memory, not 2 x QB/4
      // registers a consumer thread; lane 0's arrival on full[s] releases
      // the warp's stores (ordered before it by __syncwarp)
      const int64_t row0 = static_cast<int64_t>(bh) * a.l;
#pragma unroll
      for (int c = lane; c < QB; c += 32) {
        const bool in = q0 + c < a.l;
        lse_s[s][c] = in ? a.lse[row0 + q0 + c] * kLog2e : 0.f;
        dl_s[s][c] = in ? a.delta[row0 + q0 + c] : 0.f;
      }
      __syncwarp();
      if (lane == 0) {
        uint8_t* st = ring + s * C::kStageBytes;
        mbar_expect_tx(&full[s], C::kStageBytes);
#pragma unroll
        for (int x = 0; x < C::kBoxes; ++x) {
          tma_load_3d(st + x * C::kQBox, &map_q, &full[s], x * 64, q0, bh);
          tma_load_3d(st + C::kQ + x * C::kQBox, &map_do, &full[s], x * 64, q0, bh);
        }
      }
    }
    return;
  }

  // the consumer warpgroup: this thread's keys are key_a and key_a + 8; its
  // query columns in a step are q0 + 8j + 2 (t % 4) + c
  const int t = threadIdx.x;
  const int r0 = (t / 32) * 16 + (t % 32) / 4;
  const int key_a = k0 + r0;
  const uint32_t k_addr = smem_u32(ks);
  const uint32_t v_addr = smem_u32(vs);
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) dk[e] = dv[e] = 0.f;
  mbar_wait(&kv_full, 0);

  for (int it = 0; it < n_it; ++it) {
    const int s = it % kStages;
    const int q0 = (qt0 + it % steps) * QB;
    mbar_wait(&full[s], (it / kStages) & 1);
    const uint32_t q_addr = smem_u32(ring + s * C::kStageBytes);
    const uint32_t do_addr = q_addr + C::kQ;
    // k's and v's descriptors are the same every step: made anew here, so
    // the compiler does not keep 16 of them in registers across the loop
    uint32_t k_at = k_addr, v_at = v_addr;
    asm volatile("" : "+r"(k_at), "+r"(v_at));
    // S^T = K Q^T and dP^T = V dout^T, all four K-major
    float st[QB / 2], dpt[QB / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_bf16_kk(st, desc_sw128(k_at + (kk / 4) * kBox + (kk % 4) * 32, 16, 1024),
                    desc_sw128(q_addr + (kk / 4) * C::kQBox + (kk % 4) * 32, 16, 1024), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_bf16_kk(dpt, desc_sw128(v_at + (kk / 4) * kBox + (kk % 4) * 32, 16, 1024),
                    desc_sw128(do_addr + (kk / 4) * C::kQBox + (kk % 4) * 32, 16, 1024), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(st);
    // P^T = exp(scale s - lse), 0 where masked (causal, a key or a query >= L)
    const bool edge = q0 + QB > a.l || k0 + 64 > a.l || (a.causal && k0 + 63 > q0);
    uint32_t pa[QB / 4];
#pragma unroll
    for (int j = 0; j < QB / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float p = exp2f(st[4 * j + 2 * h + c] * a.scale_log2 -
                          lse_s[s][8 * j + 2 * (t % 4) + c]);
          if (edge) {
            const int qi = q0 + 8 * j + 2 * (t % 4) + c, key = key_a + 8 * h;
            if (qi >= a.l || key >= a.l || (a.causal && key > qi)) p = 0.f;
          }
          st[4 * j + 2 * h + c] = p;
        }
        pa[2 * j + h] = pack_bf16(st[4 * j + 2 * h], st[4 * j + 2 * h + 1]);
      }
    // dV += P^T dout: P^T in registers, dout read MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < QB / 16; ++kk) {
      const uint32_t frag[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
      wgmma_bf16_rs(dv, frag, desc_sw128(do_addr + kk * 16 * 128, C::kQBox, 1024));
    }
    wgmma_commit();
    // dP^T and the dV product: waiting for both frees P^T's bf16 copy, which
    // keeps the dk and dv accumulators, S^T, dP^T and dS^T in 255 registers
    // without a spill
    wgmma_wait<0>();
    fence_regs(dpt);
    fence_regs(dv);
    fence_regs(pa);
    // dS^T = P^T (dP^T - delta) in bf16; dK += dS^T Q, q read MN-major
    uint32_t pb[QB / 4];
#pragma unroll
    for (int j = 0; j < QB / 8; ++j) {
      const float d0 = dl_s[s][8 * j + 2 * (t % 4)], d1 = dl_s[s][8 * j + 2 * (t % 4) + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        pb[2 * j + h] = pack_bf16(st[4 * j + 2 * h] * (dpt[4 * j + 2 * h] - d0),
                                  st[4 * j + 2 * h + 1] * (dpt[4 * j + 2 * h + 1] - d1));
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < QB / 16; ++kk) {
      const uint32_t frag[4] = {pb[4 * kk], pb[4 * kk + 1], pb[4 * kk + 2], pb[4 * kk + 3]};
      wgmma_bf16_rs(dk, frag, desc_sw128(q_addr + kk * 16 * 128, C::kQBox, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(pb);
    if (t == 0) mbar_arrive(&empty[s]);
  }

  if (a.splits == 1) {
    // dk = scale * dk and dv in bf16, through the k and v tiles (no wgmma
    // reads them now) and TMA stores that drop rows >= L
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int at = sw128_at(r0 + 8 * h, j * 8 + (t % 4) * 2, kBox);
        *reinterpret_cast<uint32_t*>(ks + at) =
            pack_bf16(dk[4 * j + 2 * h] * a.scale, dk[4 * j + 2 * h + 1] * a.scale);
        *reinterpret_cast<uint32_t*>(vs + at) = pack_bf16(dv[4 * j + 2 * h], dv[4 * j + 2 * h + 1]);
      }
    fence_async_smem();
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
    if (t == 0) {
#pragma unroll
      for (int x = 0; x < C::kBoxes; ++x) {
        tma_store_3d(&map_dk, ks + x * kBox, x * 64, k0, g);
        tma_store_3d(&map_dv, vs + x * kBox, x * 64, k0, g);
      }
      tma_store_wait();
    }
  } else {
    // this split's f32 partial sums; flash_attention_bwd_split_sum_kernel
    // adds the splits in order
    const int64_t plane = static_cast<int64_t>(a.bkv) * a.l * D;
    float* pk = a.part + (2 * sp) * plane + static_cast<int64_t>(g) * a.l * D;
    float* pv = pk + plane;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = key_a + 8 * h;
      if (key >= a.l) continue;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int64_t at = static_cast<int64_t>(key) * D + j * 8 + (t % 4) * 2;
        *reinterpret_cast<float2*>(pk + at) =
            make_float2(dk[4 * j + 2 * h], dk[4 * j + 2 * h + 1]);
        *reinterpret_cast<float2*>(pv + at) =
            make_float2(dv[4 * j + 2 * h], dv[4 * j + 2 * h + 1]);
      }
    }
  }
}

// dk = scale * the sum of the splits' partial dk, dv = the sum of their dv,
// added in split order (the same bits every run), in bf16; n = B*Hkv*L*D, a
// multiple of 4.
__global__ void __launch_bounds__(256)
flash_attention_bwd_split_sum_kernel(const float* part, __nv_bfloat16* dk, __nv_bfloat16* dv,
                                     int64_t n, int splits, float scale) {
  const int64_t e = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (e >= n) return;
  float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
  for (int s = 0; s < splits; ++s) {
    const float4 x = *reinterpret_cast<const float4*>(part + (2 * s) * n + e);
    const float4 y = *reinterpret_cast<const float4*>(part + (2 * s + 1) * n + e);
    sk.x += x.x; sk.y += x.y; sk.z += x.z; sk.w += x.w;
    sv.x += y.x; sv.y += y.y; sv.z += y.z; sv.w += y.w;
  }
  uint2 uk, uv;
  uk.x = pack_bf16(sk.x * scale, sk.y * scale);
  uk.y = pack_bf16(sk.z * scale, sk.w * scale);
  uv.x = pack_bf16(sv.x, sv.y);
  uv.y = pack_bf16(sv.z, sv.w);
  *reinterpret_cast<uint2*>(dk + e) = uk;
  *reinterpret_cast<uint2*>(dv + e) = uv;
}

struct Ptrs {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  float *lse, *delta, *part;
};

template <int D, bool kLseGiven>
int launch_dq(const Ptrs& p, EncodeTiled fn, int b, int hq, int hkv, int l, float scale,
              int causal, cudaStream_t stream) {
  using C = DqCfg<D>;
  CUtensorMap map_q, map_k, map_v, map_do, map_dq;
  const int64_t bq = static_cast<int64_t>(b) * hq, bk = static_cast<int64_t>(b) * hkv;
  if (!encode_3d(fn, &map_q, p.q, bq, l, D, 64, 64) ||
      !encode_3d(fn, &map_k, p.k, bk, l, D, 64, 64) ||
      !encode_3d(fn, &map_v, p.v, bk, l, D, 64, 64) ||
      !encode_3d(fn, &map_do, p.dout, bq, l, D, 64, 64) ||
      !encode_3d(fn, &map_dq, p.dq, bq, l, D, 64, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_attention_bwd_dq_kernel_wgmma<D, kLseGiven>;
  // per call: the attribute belongs to the current device
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nqb = (l + 63) / 64;
  const int64_t blocks = static_cast<int64_t>(nqb) * bq;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  const DqArgs a{p.o, p.dout, p.lse, p.delta, l, hq, hkv, nqb, b * hq, scale, scale * kLog2e,
                 causal};
  kernel<<<static_cast<unsigned>(blocks), C::kThreads, C::kSmem, stream>>>(map_q, map_k, map_v,
                                                                           map_do, map_dq, a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkdv(const Ptrs& p, EncodeTiled fn, int b, int hq, int hkv, int l, float scale,
                int causal, int splits, cudaStream_t stream) {
  using C = KvCfg<D>;
  CUtensorMap map_q, map_k, map_v, map_do, map_dk, map_dv;
  const int64_t bq = static_cast<int64_t>(b) * hq, bk = static_cast<int64_t>(b) * hkv;
  if (!encode_3d(fn, &map_q, p.q, bq, l, D, C::kQB, 64) ||
      !encode_3d(fn, &map_k, p.k, bk, l, D, 64, 64) ||
      !encode_3d(fn, &map_v, p.v, bk, l, D, 64, 64) ||
      !encode_3d(fn, &map_do, p.dout, bq, l, D, C::kQB, 64) ||
      !encode_3d(fn, &map_dk, p.dk, bk, l, D, 64, 64) ||
      !encode_3d(fn, &map_dv, p.dv, bk, l, D, 64, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_attention_bwd_dkdv_kernel_wgmma<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nkb = (l + 63) / 64;
  const int64_t blocks = static_cast<int64_t>(nkb) * bk * splits;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  const KvArgs a{p.lse, p.delta, p.part, l, hq, hkv, b * hkv, splits, scale, scale * kLog2e,
                 causal};
  kernel<<<static_cast<unsigned>(blocks), C::kThreads, C::kSmem, stream>>>(
      map_q, map_k, map_v, map_do, map_dk, map_dv, a);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int64_t n = bk * l * D;
  const int64_t sum_blocks = (n / 4 + 255) / 256;
  flash_attention_bwd_split_sum_kernel<<<static_cast<unsigned>(sum_blocks), 256, 0, stream>>>(
      p.part, static_cast<__nv_bfloat16*>(p.dk), static_cast<__nv_bfloat16*>(p.dv), n, splits,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const Ptrs& p, int lse_given, int b, int hq, int hkv, int l, float scale, int causal,
           int splits, cudaStream_t stream) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int e = lse_given ? launch_dq<D, true>(p, fn, b, hq, hkv, l, scale, causal, stream)
                          : launch_dq<D, false>(p, fn, b, hq, hkv, l, scale, causal, stream);
  if (e != 0) return e;
  return launch_dkdv<D>(p, fn, b, hq, hkv, l, scale, causal, splits, stream);
}

}  // namespace wg

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// q, o, dout, dq (B,Hq,L,Dh); k, v, dk, dv (B,Hkv,L,Dh), all contiguous, of
// one dtype (0 = f32, 1 = bf16) and 16-byte aligned; lse and delta f32
// scratch of B*Hq*L each.  d: 16, 64 or 128.  Launches the dq kernel, then
// the dk/dv kernel, on `stream`.  Returns a cudaError_t (0 on success).
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, void* dq, void* dk,
                                         void* dv, float* lse, float* delta, int b, int hq,
                                         int hkv, int l, int d, float scale, int causal,
                                         int dtype, void* stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || l <= 0 || hq % hkv != 0 || b * hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[] = {q, k, v, o, dout, dq, dk, dv, lse, delta};
  for (const void* p : ptrs)
    if (!aligned16(p)) return static_cast<int>(cudaErrorMisalignedAddress);
  const BwdArgs a{q, k, v, o, dout, dq, dk, dv, lse, delta, b, hq, hkv, l, scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 16: return dtype == 0 ? launch<float, 16>(a, s) : launch<__nv_bfloat16, 16>(a, s);
    case 64: return dtype == 0 ? launch<float, 64>(a, s) : launch<__nv_bfloat16, 64>(a, s);
    case 128: return dtype == 0 ? launch<float, 128>(a, s) : launch<__nv_bfloat16, 128>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bf16 route (kernels/attention.route_bwd): q, o, dout, dq (B,Hq,L,Dh) and
// k, v, dk, dv (B,Hkv,L,Dh) bf16, contiguous and 16-byte aligned, d 64 or
// 128; lse f32 (B*Hq, L): the forward's rows' log-sum-exp when lse_given,
// else scratch that the dq kernel fills in a first pass; delta f32 scratch
// (B*Hq, L); part, when splits > 1, f32 scratch of splits * 2 * B*Hkv*L*d;
// splits divides Hq/Hkv.
// Launches the dq kernel, the dk/dv kernel and, with splits > 1, the split
// sum, on `stream`.  Returns a cudaError_t (0 on success).
extern "C" int repro_flash_attention_bwd_wgmma(const void* q, const void* k, const void* v,
                                               const void* o, const void* dout, void* dq,
                                               void* dk, void* dv, float* lse, int lse_given,
                                               float* delta, float* part, int b, int hq, int hkv,
                                               int l, int d, float scale, int causal, int splits,
                                               void* stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || l <= 0 || hq % hkv != 0 || splits < 1 ||
      (hq / hkv) % splits != 0 || (splits > 1 && part == nullptr) ||
      lse == nullptr || delta == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[] = {q, k, v, o, dout, dq, dk, dv, lse, delta};
  for (const void* p : ptrs)
    if (p == nullptr || !aligned16(p)) return static_cast<int>(cudaErrorMisalignedAddress);
  if (splits > 1 && !aligned16(part)) return static_cast<int>(cudaErrorMisalignedAddress);
  const wg::Ptrs p{q, k, v, o, dout, dq, dk, dv, lse, delta, part};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return wg::launch<64>(p, lse_given, b, hq, hkv, l, scale, causal, splits, s);
    case 128: return wg::launch<128>(p, lse_given, b, hq, hkv, l, scale, causal, splits, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
