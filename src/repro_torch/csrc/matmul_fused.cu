// K6 on Hopper: matmul with the fused bias / residual / activation epilogue.
//
// Replaces the Pallas kernel repro/kernels/matmul_fused.py:matmul_fused
// (_kernel).  Same function: out = act(a @ b + bias [+ residual]) with
// a (M,K), b (K,N), bias (N,), residual (M,N), all row-major and of one
// dtype (f32 or bf16), f32 accumulation, act in {none, relu, gelu (tanh
// form), silu}, out in a's dtype.  Built with nvcc for sm_90a and bound
// through the plain C function at the bottom (ctypes; see
// repro_torch/kernels/_build.py).
//
// Design: a register-tiled GEMM on the SIMT cores, the tiling of
// csrc/conv2d_direct.cu without the im2col gather.
//   * A block of 256 threads owns a BM x BN output tile and walks K in
//     steps of 8: the a slice (BM x 8, stored transposed) and the b slice
//     (8 x BN) are staged in shared memory as f32, double buffered through
//     registers so the next step's loads overlap this step's FMAs.
//   * Each thread keeps a TM x TN tile of outputs in registers (8x8 on the
//     128x128 tile, 4x4 on the 64x64 tile chosen when 128x128 tiles would
//     not give every SM a block), in float4 groups 64 rows / columns apart.
//   * The epilogue runs on the register tile before the single store, in the
//     reference's order (matmul_fused.py:48-56): + bias, + residual, act.
//   * Every M, N, K tail is masked on load and store; float4 / 8-byte loads
//     are used where the row length and the base pointers allow.
// Offsets are 64-bit.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 8;  // k-steps per staged slice

enum Act { kNone = 0, kRelu = 1, kGelu = 2, kSilu = 3 };

struct MmArgs {
  const void* a;
  const void* b;
  const void* bias;      // may be null
  const void* residual;  // may be null
  void* out;
  int m, n, k, act;
  bool vec_a;  // K % 4 == 0 and a aligned: whole quads of a row load at once
  bool vec_n;  // N % 4 == 0 and b, bias, residual, out aligned
};

// Elements of a quad at `at` that lie before `total` (may be <= 0).
__device__ __forceinline__ int in_bounds(int64_t total, int64_t at) {
  const int64_t r = total - at;
  return r < 4 ? static_cast<int>(r) : 4;
}


// p[0..3], of which the first n are in bounds (the rest read as 0).
__device__ __forceinline__ void load4(const float* p, int n, bool vec, float v[4]) {
  if (vec && n >= 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = c < n ? p[c] : 0.f;
  }
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, int n, bool vec, float v[4]) {
  if (vec && n >= 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = c < n ? __bfloat162float(p[c]) : 0.f;
  }
}

__device__ __forceinline__ void store4(float* p, int n, bool vec, const float v[4]) {
  if (vec && n >= 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c < n) p[c] = v[c];
  }
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, int n, bool vec, const float v[4]) {
  if (vec && n >= 4) {
    uint2 u;
    *reinterpret_cast<__nv_bfloat162*>(&u.x) = __floats2bfloat162_rn(v[0], v[1]);
    *reinterpret_cast<__nv_bfloat162*>(&u.y) = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = u;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c < n) p[c] = __float2bfloat16_rn(v[c]);
  }
}

__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case kRelu:
      return fmaxf(x, 0.f);
    case kGelu:  // jax.nn.gelu(approximate=True)
      return 0.5f * x * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
    case kSilu:
      return x / (1.f + expf(-x));
    default:
      return x;
  }
}

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(kThreads)
matmul_fused_kernel(const MmArgs p) {
  constexpr int TM = BM / 16, TN = BN / 16;  // 16 x 16 threads
  static_assert(TM % 4 == 0 && TN % 4 == 0, "register tiles are float4 groups");
  constexpr int kAQuads = BM * kBK / 4;  // quads of a staged per step
  constexpr int kBQuads = BN * kBK / 4;
  static_assert(kAQuads <= kThreads && kBQuads <= kThreads, "one quad per thread");
  __shared__ __align__(16) float as[2][kBK][BM + 4];  // a slice, transposed
  __shared__ __align__(16) float bs[2][kBK][BN];

  const T* a = static_cast<const T*>(p.a);
  const T* b = static_cast<const T*>(p.b);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * BN;

  // the quad this thread stages: a row am, k-offset akq; b row bk, column bnq
  const int am = tid / 2, akq = (tid % 2) * 4;
  const int bkr = tid / (BN / 4), bnq = (tid % (BN / 4)) * 4;
  float ra[4], rb[4];
  auto gload = [&](int k0) {
    if (tid < kAQuads) {
      const int64_t row = m0 + am;
      const int kk = k0 + akq;
      const int n = row < p.m ? in_bounds(p.k, kk) : 0;
      load4(a + row * p.k + kk, n, p.vec_a, ra);
    }
    if (tid < kBQuads) {
      const int kk = k0 + bkr;
      const int64_t col = n0 + bnq;
      const int n = kk < p.k ? in_bounds(p.n, col) : 0;
      load4(b + static_cast<int64_t>(kk) * p.n + col, n, p.vec_n, rb);
    }
  };
  auto sstore = [&](int buf) {
    if (tid < kAQuads) {
#pragma unroll
      for (int c = 0; c < 4; ++c) as[buf][akq + c][am] = ra[c];
    }
    if (tid < kBQuads)
      *reinterpret_cast<float4*>(&bs[buf][bkr][bnq]) = make_float4(rb[0], rb[1], rb[2], rb[3]);
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int nk = (p.k + kBK - 1) / kBK;
  if (nk > 0) {
    gload(0);
    sstore(0);
  }
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) gload((kt + 1) * kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float va[TM], vb[TN];
#pragma unroll
      for (int g = 0; g < TM / 4; ++g) {
        const float4 f = *reinterpret_cast<const float4*>(&as[buf][kk][g * 64 + ty * 4]);
        va[g * 4] = f.x; va[g * 4 + 1] = f.y; va[g * 4 + 2] = f.z; va[g * 4 + 3] = f.w;
      }
#pragma unroll
      for (int g = 0; g < TN / 4; ++g) {
        const float4 f = *reinterpret_cast<const float4*>(&bs[buf][kk][g * 64 + tx * 4]);
        vb[g * 4] = f.x; vb[g * 4 + 1] = f.y; vb[g * 4 + 2] = f.z; vb[g * 4 + 3] = f.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(va[i], vb[j], acc[i][j]);
    }
    if (kt + 1 < nk) sstore(buf ^ 1);
    __syncthreads();
  }

  const T* bias = static_cast<const T*>(p.bias);
  const T* res = static_cast<const T*>(p.residual);
  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t row = m0 + (i / 4) * 64 + ty * 4 + (i % 4);
    if (row >= p.m) continue;
#pragma unroll
    for (int g = 0; g < TN / 4; ++g) {
      const int64_t col = n0 + g * 64 + tx * 4;
      const int n = in_bounds(p.n, col);
      if (n <= 0) continue;
      float v[4], e[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) v[c] = acc[i][g * 4 + c];
      if (bias != nullptr) {
        load4(bias + col, n, p.vec_n, e);
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] = __fadd_rn(v[c], e[c]);
      }
      if (res != nullptr) {
        load4(res + row * p.n + col, n, p.vec_n, e);
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] = __fadd_rn(v[c], e[c]);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) v[c] = activate(v[c], p.act);
      store4(out + row * p.n + col, n, p.vec_n, v);
    }
  }
}

template <typename T>
int launch(const MmArgs& p, cudaStream_t stream) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  const int64_t big = ((p.m + 127) / 128) * static_cast<int64_t>((p.n + 127) / 128);
  if (big >= sms) {
    const dim3 grid((p.n + 127) / 128, (p.m + 127) / 128);
    matmul_fused_kernel<T, 128, 128><<<grid, kThreads, 0, stream>>>(p);
  } else {
    const dim3 grid((p.n + 63) / 64, (p.m + 63) / 64);
    matmul_fused_kernel<T, 64, 64><<<grid, kThreads, 0, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* ptr, uintptr_t bytes) {
  return ptr == nullptr || (reinterpret_cast<uintptr_t>(ptr) % bytes) == 0;
}

}  // namespace

// act: 0 none, 1 relu, 2 gelu (tanh), 3 silu.  dtype: 0 = f32, 1 = bf16 for
// a, b, bias, residual and out alike.  Returns a cudaError_t (0 on success).
extern "C" int repro_matmul_fused(const void* a, const void* b, const void* bias,
                                  const void* residual, void* out, int m, int n, int k, int act,
                                  int dtype, void* stream) {
  if (m <= 0 || n <= 0 || k < 0 || act < kNone || act > kSilu || (m + 63) / 64 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t quad = dtype == 0 ? 16 : 8;  // bytes of four elements
  MmArgs p{a, b, bias, residual, out, m, n, k, act, false, false};
  p.vec_a = k % 4 == 0 && aligned(a, quad);
  p.vec_n = n % 4 == 0 && aligned(b, quad) && aligned(bias, quad) && aligned(residual, quad) &&
            aligned(out, quad);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
