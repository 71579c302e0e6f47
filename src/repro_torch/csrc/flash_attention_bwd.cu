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
// This first kernel is the simple one, f32 FMA on the SIMT cores: tensor
// cores, TMA and a log-sum-exp saved by the forward are later work.  It
// needs no atomics and gives the same bits run to run.  Two kernels, one
// after the other on the caller's stream:
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
