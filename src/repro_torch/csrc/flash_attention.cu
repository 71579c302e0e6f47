// K7 on Hopper: blocked (flash-style) attention with an online softmax.
//
// Replaces the Pallas kernel repro/kernels/attention.py:flash_attention
// (_kernel).  Same function: q (B,Hq,L,Dh), k and v (B,Hkv,L,Dh), query head
// h reads KV head h / (Hq/Hkv); out = softmax(scale * q k^T [causal]) v in
// q's dtype (f32 or bf16), with f32 logits and accumulator.  Built with nvcc
// for sm_90a and bound through the plain C function at the bottom (ctypes;
// see repro_torch/kernels/_build.py).
//
// Design, SIMT f32 on the CUDA cores:
//   * One block of 256 threads per (b*Hq + h, 64-query block).  The block
//     walks the 64-key blocks of its KV head in order and, when causal,
//     stops at the diagonal block (the reference's pl.when skip of fully
//     masked blocks).  Causal blocks are issued heaviest first.
//   * Q (scaled by `scale` as it is staged, as at attention.py:36) and each
//     K block sit transposed in shared memory as f32, so a thread reads four
//     queries or four keys of one feature with one float4; each V block sits
//     as it is.  A thread owns 4 query rows x 4 keys of S and 4 query rows x
//     Dh/16 features of the output, kept in registers across the key loop.
//     Dh is a template parameter: 16, 64 or 128.
//   * Per key block the running max m and sum l of each row are updated
//     (attention.py:44-52) with a shuffle over the 16 threads of a row, the
//     accumulator is rescaled by exp(m_prev - m_cur), and P = exp(S - m_cur)
//     goes through shared memory into P V.  m starts at the finite -1e30 so
//     exp(m_prev - m_cur) is never exp(-inf + inf); a masked logit gets
//     p = 0 exactly, whatever the row's max.
//   * Query and key tails are masked (rows >= L never stored, keys >= L
//     staged as zeros and given p = 0), so any L >= 1 is legal.
//   * The output is acc / l, written once in q's dtype.
// Offsets are 64-bit.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;          // queries per block
constexpr int kBK = 64;          // keys per step
constexpr int kPStride = kBK + 4;  // row stride of P in shared memory
constexpr float kNeg = -1e30f;

struct FaArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
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

// Rows [row0, row0 + 64) of a (L, D) matrix, transposed into dst[D][64] as
// f32 times `mul`; rows >= L become zeros.  A warp covers 32 consecutive
// rows of one 4-feature group, so its shared-memory stores are
// conflict-free.
template <typename T, int D>
__device__ __forceinline__ void stage_transposed(float* dst, const T* src, int row0, int l,
                                                 float mul) {
  const int i = threadIdx.x % kBQ;
  const bool in = row0 + i < l;
  for (int dq = threadIdx.x / kBQ; dq < D / 4; dq += kThreads / kBQ) {
    float x[4];
    load4(src + static_cast<int64_t>(row0 + i) * D + dq * 4, in ? 4 : 0, x);
#pragma unroll
    for (int c = 0; c < 4; ++c) dst[(dq * 4 + c) * kBQ + i] = x[c] * mul;
  }
}

// Rows [row0, row0 + 64) of a (L, D) matrix into dst[64][D] as f32, rows
// >= L as zeros; coalesced, contiguous float4 stores.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int row0, int l) {
  for (int e = threadIdx.x; e < kBK * D / 4; e += kThreads) {
    const int j = e / (D / 4), dq = e % (D / 4);
    float x[4];
    load4(src + static_cast<int64_t>(row0 + j) * D + dq * 4, row0 + j < l ? 4 : 0, x);
    store4(dst + j * D + dq * 4, x);
  }
}

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const FaArgs a) {
  static_assert(D % 16 == 0 && D <= 128, "16 threads share a row's D features");
  // A thread owns D/16 features of the output: kG vectors of VW, the
  // vectors of the 16 threads of a row side by side.
  constexpr int VW = D >= 64 ? 4 : D / 16;
  constexpr int kG = D / (16 * VW);
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [D][kBQ], scaled q, transposed
  float* kt = qt + D * kBQ;                      // [D][kBK], k transposed
  float* vs = kt + D * kBK;                      // [kBK][D]
  float* ps = vs + kBK * D;                      // [kBQ][kPStride]

  const int tx = threadIdx.x % 16;  // keys tx*4.. of S; features (16g + tx)*VW.. of O
  const int ty = threadIdx.x / 16;  // query rows ty*4..ty*4+3
  const int l = a.l;
  const int nqb = (l + kBQ - 1) / kBQ;
  const int qb = nqb - 1 - static_cast<int>(blockIdx.x);  // heaviest first
  const int q0 = qb * kBQ;
  const int64_t bh = blockIdx.y;
  const int64_t kvh = bh / (a.hq / a.hkv);
  const T* q = static_cast<const T*>(a.q) + bh * l * D;
  const T* k = static_cast<const T*>(a.k) + kvh * l * D;
  const T* v = static_cast<const T*>(a.v) + kvh * l * D;
  T* out = static_cast<T*>(a.out) + bh * l * D;

  stage_transposed<T, D>(qt, q, q0, l, a.scale);

  float acc[4][VW * kG];
  float m[4], lsum[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNeg;
    lsum[r] = 0.f;
#pragma unroll
    for (int c = 0; c < VW * kG; ++c) acc[r][c] = 0.f;
  }

  const int nkb = (l + kBK - 1) / kBK;
  const int kb_end = a.causal ? min(nkb, qb + 1) : nkb;
  for (int kb = 0; kb < kb_end; ++kb) {
    const int k0 = kb * kBK;
    stage_transposed<T, D>(kt, k, k0, l, 1.f);
    stage_rows<T, D>(vs, v, k0, l);
    __syncthreads();

    // S = (scale q) k^T for rows ty*4.., keys tx*4..
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

    // online softmax, one row at a time; the 16 threads of a row are the
    // 16 lanes of one half-warp, so xor-shuffles over 8..1 stay in the row
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
      const float alpha = expf(m[r] - m_cur);
      float p[4], sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        p[c] = ok[c] ? expf(s[r][c] - m_cur) : 0.f;
        sum += p[c];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      lsum[r] = lsum[r] * alpha + sum;
      m[r] = m_cur;
#pragma unroll
      for (int c = 0; c < VW * kG; ++c) acc[r][c] *= alpha;
      store4(ps + (ty * 4 + r) * kPStride + tx * 4, p);
    }
    __syncthreads();

    // acc += P V
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float pr[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 pv = *reinterpret_cast<const float4*>(ps + (ty * 4 + r) * kPStride + j);
        pr[r][0] = pv.x; pr[r][1] = pv.y; pr[r][2] = pv.z; pr[r][3] = pv.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          float vc[VW];
          lds<VW>(vs + (j + jj) * D + (g * 16 + tx) * VW, vc);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < VW; ++c)
              acc[r][g * VW + c] = fmaf(pr[r][jj], vc[c], acc[r][g * VW + c]);
        }
      }
    }
    __syncthreads();  // before the next block overwrites kt, vs, ps
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + ty * 4 + r;
    if (qi >= l) continue;
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      T* dst = out + static_cast<int64_t>(qi) * D + (g * 16 + tx) * VW;
      float o[4];
#pragma unroll
      for (int c = 0; c < VW; ++c) o[c] = acc[r][g * VW + c] / lsum[r];
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
int launch(const FaArgs& a, cudaStream_t stream) {
  constexpr size_t smem = (static_cast<size_t>(2 * D * kBQ + kBK * D + kBQ * kPStride)) *
                          sizeof(float);
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<T, D>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid((a.l + kBQ - 1) / kBQ, a.b * a.hq);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// dtype: 0 = f32, 1 = bf16 (q, k, v and out alike).  d: 16, 64 or 128.
// Returns a cudaError_t (0 on success).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     int b, int hq, int hkv, int l, int d, float scale,
                                     int causal, int dtype, void* stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || l <= 0 || hq % hkv != 0 || b * hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out))
    return static_cast<int>(cudaErrorMisalignedAddress);
  FaArgs a{q, k, v, out, b, hq, hkv, l, scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 16: return dtype == 0 ? launch<float, 16>(a, s) : launch<__nv_bfloat16, 16>(a, s);
    case 64: return dtype == 0 ? launch<float, 64>(a, s) : launch<__nv_bfloat16, 64>(a, s);
    case 128: return dtype == 0 ? launch<float, 128>(a, s) : launch<__nv_bfloat16, 128>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
