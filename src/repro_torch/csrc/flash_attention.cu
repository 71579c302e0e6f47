// K7 on Hopper: blocked (flash-style) attention with an online softmax.
//
// Replaces the Pallas kernel repro/kernels/attention.py:flash_attention
// (_kernel).  Same function: q (B,Hq,L,Dh), k and v (B,Hkv,L,Dh), query head
// h reads KV head h / (Hq/Hkv); out = softmax(scale * q k^T [causal]) v in
// q's dtype (f32 or bf16), with f32 logits and accumulator.  Built with nvcc
// for sm_90a and bound through the plain C functions at the bottom (ctypes;
// see repro_torch/kernels/_build.py).
//
// What bounds it on an H100: causal attention does about L / 2 FLOP per byte
// of q, k, v and out (about 440 at L = 1024 with Qwen2-1.5B's heads), above
// the ridge, so the arithmetic rate: 989 TFLOP/s on the bf16 tensor cores,
// 67 TFLOP/s f32 on the SIMT cores.  At batch 1 and L 1024 a launch holds
// only 3.2 GFLOP (3.3 us at the bf16 peak), so filling 132 SMs and the
// latency of each key block's chain (S, softmax, P V) bound it in practice.
// Two kernels, one route each, chosen in the wrapper
// (kernels/attention.route):
//
// flash_attention_kernel_wgmma, bf16 with Dh 64 or 128, contiguous and
// 16-byte aligned (TMA):
//   * a block owns 64 queries of one (batch, head): one consumer warpgroup
//     and a producer warp (128-query tiles on two warpgroups, one block an
//     SM by registers, measured slower; PERF.md); block i takes the
//     query tile nqb - 1 - i / (B*Hq) of head i % (B*Hq), so every head's
//     heaviest causal tiles go first;
//   * the producer's one thread loads the q tile once and keeps TMA loads
//     of K and V blocks in flight in a 2-stage ring on mbarriers; the
//     tensor maps are 3-D over (Dh, L, B*H), so a block's tail past L
//     reads zeros, never the next head's rows, and the output store drops
//     rows >= L; Dh 128 is two 64-column boxes in 128-byte swizzle; causal
//     blocks stop at the diagonal;
//   * a key block is 64 keys (two blocks an SM) or 128 (one block an SM,
//     half the loop's steps), picked in the wrapper by shape
//     (kernels/attention.wgmma_key_block, from measurements);
//   * S = Q K^T: wgmma m64n64k16 or m64n128k16 with q and k both K-major
//     (k's rows are the keys); the softmax runs in f32 on the accumulator
//     fragment: scale times log2(e) is applied to S after the product (the
//     reference scales q in f32), a row's max and sum reduce over the 4
//     lanes of a quad, m starts at the finite -1e30, masked logits get
//     p = 0 exactly;
//   * O += P V: P, rounded to bf16, stays in registers: the S fragment is
//     the A operand's register fragment pair for pair, so no shuffle and no
//     shared memory; v is read MN-major through the transpose bit (wgmma
//     m64n128k16 at Dh 128, m64n64k16 at Dh 64), as K6 reads b;
//   * out = acc / l in bf16 through the q tile in the 128-byte swizzle and
//     TMA stores.  The helpers live in hopper.cuh.
//
// flash_attention_kernel, f32 (held to 1e-5) and bf16 off that rule (Dh 16,
// the smoke configs'), SIMT f32 on the CUDA cores:
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

#include "hopper.cuh"  // TMA, mbarriers, wgmma, the tensor-map encoder

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
  // per call: the attribute belongs to the current device
  const cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<T, D>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.l + kBQ - 1) / kBQ, a.b * a.hq);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---- the bf16 route: TMA + wgmma ----------------------------------------

namespace wg {

using namespace hopper;

constexpr int kBQ = 64;              // queries per block: one consumer warpgroup
constexpr int kStages = 2;           // the K/V ring
constexpr int kBox = 64 * 64 * 2;    // one 64 x 64 bf16 box of q or out, 8 KB
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// D: the head width (64 or 128); KB: keys per block of the loop (64 or 128;
// kernels/attention.wgmma_key_block picks it).
template <int D, int KB>
struct Cfg {
  static constexpr int kBoxes = D / 64;          // boxes across Dh
  static constexpr int kQ = kBQ * D * 2;         // the q tile
  static constexpr int kBoxKV = KB * 64 * 2;     // one box of a k or v block
  static constexpr int kKV = KB * D * 2;         // a k or v block
  static constexpr int kStageBytes = 2 * kKV;    // k, then v
  static constexpr int kSmem = kQ + kStages * kStageBytes + 1024;  // + 1 KB alignment
  static constexpr int kThreads = 128 + 32;      // + one producer warp
  static constexpr int kBlocksPerSm = KB == 64 ? 2 : 1;  // what shared memory allows
};

struct Args {
  int l, hq, hkv;
  int nqb;           // query tiles per head
  int bh;            // B * Hq
  float scale_log2;  // scale * log2(e)
  int causal;
  float* lse;        // (B*Hq, L) f32 log-sum-exp of each row, or null
};

// One block: 64 queries of one (batch, query head).  Block i takes query
// tile nqb - 1 - i / bh of head i % bh, so every head's heaviest causal
// tiles are issued first.
template <int D, int KB>
__global__ void __launch_bounds__(Cfg<D, KB>::kThreads, Cfg<D, KB>::kBlocksPerSm)
flash_attention_kernel_wgmma(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             const __grid_constant__ CUtensorMap map_out, const Args a) {
  using C = Cfg<D, KB>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full;
  __shared__ __align__(8) uint64_t full[kStages];   // the stage's k and v landed
  __shared__ __align__(8) uint64_t empty[kStages];  // the consumer is done with it
  // 128-byte swizzle repeats every 1 KB: the tiles start on a 1 KB boundary
  uint8_t* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = qs + C::kQ;
  const int bh = static_cast<int>(blockIdx.x) % a.bh;
  const int q0 = (a.nqb - 1 - static_cast<int>(blockIdx.x) / a.bh) * kBQ;
  const int kvh = bh / (a.hq / a.hkv);
  const int nkb = (a.l + KB - 1) / KB;
  // causal: the key blocks up to the one that holds the tile's last query
  const int kb_end = a.causal ? min(nkb, (q0 + kBQ - 1) / KB + 1) : nkb;

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
      mbar_expect_tx(&q_full, C::kQ);
#pragma unroll
      for (int x = 0; x < C::kBoxes; ++x)
        tma_load_3d(qs + x * kBox, &map_q, &q_full, x * 64, q0, bh);
      for (int kb = 0; kb < kb_end; ++kb) {
        const int s = kb % kStages;
        mbar_wait(&empty[s], ((kb / kStages) & 1) ^ 1);  // the first round passes
        uint8_t* ks = ring + s * C::kStageBytes;
        mbar_expect_tx(&full[s], C::kStageBytes);
#pragma unroll
        for (int x = 0; x < C::kBoxes; ++x) {
          tma_load_3d(ks + x * C::kBoxKV, &map_k, &full[s], x * 64, kb * KB, kvh);
          tma_load_3d(ks + C::kKV + x * C::kBoxKV, &map_v, &full[s], x * 64, kb * KB, kvh);
        }
      }
    }
    return;
  }

  // the consumer warpgroup: this thread's two rows are row_a and row_a + 8
  // (the accumulator fragment, hopper.cuh)
  const int t = threadIdx.x;
  const int row_a = q0 + (t / 32) * 16 + (t % 32) / 4;
  const uint32_t q_addr = smem_u32(qs);
  float acc[D / 2];  // O, 64 x Dh f32
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-1e30f, -1e30f};  // running max of scale*log2(e)*s
  float lsum[2] = {0.f, 0.f};     // this thread's share of the running sum
  mbar_wait(&q_full, 0);

  for (int kb = 0; kb < kb_end; ++kb) {
    const int s = kb % kStages;
    const int k0 = kb * KB;
    mbar_wait(&full[s], (kb / kStages) & 1);
    const uint32_t k_addr = smem_u32(ring + s * C::kStageBytes);
    const uint32_t v_addr = k_addr + C::kKV;

    // S = Q K^T (64 x KB f32): q and k both K-major, 16 of Dh a step
    float sc[KB / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_bf16_kk(sc, desc_sw128(q_addr + (kk / 4) * kBox + off, 16, 1024),
                    desc_sw128(k_addr + (kk / 4) * C::kBoxKV + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // online softmax in f32 on the fragment: scale after the product, log2(e)
    // folded in; a masked logit (causal, or a key >= L) gets p = 0 exactly
    const bool edge = k0 + KB > a.l || (a.causal && k0 + KB - 1 > q0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < KB / 8; ++j)
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
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // a row's keys lie on the 4 lanes of a quad
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
    }
    // P in bf16: the S fragment is the A fragment of P V, pair for pair
    // (k16 step kk reads pa[4kk .. 4kk+3])
    uint32_t pa[KB / 4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < KB / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float p0 = exp2f(sc[4 * j + 2 * h] - m[h]);
        const float p1 = exp2f(sc[4 * j + 2 * h + 1] - m[h]);
        rs[h] += p0 + p1;
        const __nv_bfloat162 pb = __floats2bfloat162_rn(p0, p1);
        pa[2 * j + h] = *reinterpret_cast<const uint32_t*>(&pb);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) lsum[h] = lsum[h] * alpha[h] + rs[h];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        acc[4 * j + 2 * h] *= alpha[h];
        acc[4 * j + 2 * h + 1] *= alpha[h];
      }

    // O += P V: P from registers, v read MN-major through the transpose bit
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KB / 16; ++kk) {
      const uint32_t frag[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
      wgmma_bf16_rs(acc, frag, desc_sw128(v_addr + kk * 16 * 128, C::kBoxKV, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
    if (t == 0) mbar_arrive(&empty[s]);
  }

  // out = acc / l in bf16, through the q tile (the wgmmas that read it are
  // done) in the 128-byte swizzle, and TMA stores that drop rows >= L
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 1);
    lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 2);
  }
  const float inv[2] = {1.f / lsum[0], 1.f / lsum[1]};
  const int r0 = (t / 32) * 16 + (t % 32) / 4;
  if (a.lse != nullptr && t % 4 == 0) {
    // logsumexp(scale q k^T [mask]) in natural-log units, from the log2
    // domain's running max and sum; the output below does not read it
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row_a + 8 * h < a.l)
        a.lse[static_cast<int64_t>(bh) * a.l + row_a + 8 * h] =
            (m[h] + log2f(lsum[h])) * kLn2;
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<__nv_bfloat162*>(qs + sw128_at(r0 + 8 * h, j * 8 + (t % 4) * 2, kBox)) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] * inv[h], acc[4 * j + 2 * h + 1] * inv[h]);
  fence_async_smem();
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
  if (t == 0) {
#pragma unroll
    for (int x = 0; x < C::kBoxes; ++x) tma_store_3d(&map_out, qs + x * kBox, x * 64, q0, bh);
    tma_store_wait();
  }
}

template <int D, int KB>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int b, int hq,
           int hkv, int l, float scale, int causal, cudaStream_t stream) {
  using C = Cfg<D, KB>;
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map_q, map_k, map_v, map_out;
  if (!encode_3d(fn, &map_q, q, static_cast<int64_t>(b) * hq, l, D, kBQ, 64) ||
      !encode_3d(fn, &map_k, k, static_cast<int64_t>(b) * hkv, l, D, KB, 64) ||
      !encode_3d(fn, &map_v, v, static_cast<int64_t>(b) * hkv, l, D, KB, 64) ||
      !encode_3d(fn, &map_out, out, static_cast<int64_t>(b) * hq, l, D, kBQ, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  // per call: the attribute belongs to the current device
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel_wgmma<D, KB>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nqb = (l + kBQ - 1) / kBQ;
  const int64_t blocks = static_cast<int64_t>(nqb) * b * hq;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{l, hq, hkv, nqb, b * hq, scale * kLog2e, causal, lse};
  flash_attention_kernel_wgmma<D, KB><<<static_cast<unsigned>(blocks), C::kThreads, C::kSmem,
                                        stream>>>(map_q, map_k, map_v, map_out, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

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

// The bf16 route: q (B,Hq,L,Dh), k and v (B,Hkv,L,Dh), out like q, all bf16,
// contiguous and 16-byte aligned, with d 64 or 128 (kernels/attention.route);
// kb, the keys per block of the loop, 64 or 128
// (kernels/attention.wgmma_key_block); lse, null or f32 (B*Hq, L): each
// row's log-sum-exp of scale * q k^T over its unmasked keys, natural log,
// which K7's backward reads (writing it changes no bit of out).  Returns a
// cudaError_t: cudaErrorInvalidValue for arguments off that rule or a
// tensor map cuTensorMapEncodeTiled refuses, cudaErrorNotSupported when
// libcuda has no cuTensorMapEncodeTiled.
extern "C" int repro_flash_attention_wgmma(const void* q, const void* k, const void* v, void* out,
                                           float* lse, int b, int hq, int hkv, int l, int d,
                                           float scale, int causal, int kb, void* stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || l <= 0 || hq % hkv != 0 || q == nullptr ||
      k == nullptr || v == nullptr || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64 && kb == 64)
    return wg::launch<64, 64>(q, k, v, out, lse, b, hq, hkv, l, scale, causal, s);
  if (d == 64 && kb == 128)
    return wg::launch<64, 128>(q, k, v, out, lse, b, hq, hkv, l, scale, causal, s);
  if (d == 128 && kb == 64)
    return wg::launch<128, 64>(q, k, v, out, lse, b, hq, hkv, l, scale, causal, s);
  if (d == 128 && kb == 128)
    return wg::launch<128, 128>(q, k, v, out, lse, b, hq, hkv, l, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
