// K8 on Hopper: depthwise causal conv1d, the Mamba mixer's short convolution.
//
// Replaces the Pallas kernel repro/kernels/conv1d_causal.py:conv1d_causal
// (_kernel).  Same function:
//   y[b, l, d] = act(bias[d] + sum_i x[b, l - KW + 1 + i, d] * w[i, d])
// with x (B,L,D) (rows may be strided, channels contiguous), w (KW,D),
// bias (D,) or none, y (B,L,D) contiguous, all of one dtype (f32 or bf16),
// f32 accumulation, x read as zero before l = 0, act in {none, silu}, y in
// x's dtype.  Built with nvcc for sm_90a and bound through the plain C
// function at the bottom (ctypes; see repro_torch/kernels/_build.py).
//
// What bounds it: KW multiply-adds per output against one read of x and one
// write of y, so HBM bandwidth (2 * B*L*D * bytes / 3.35 TB/s).
//
// Design: one pass over x, coalesced along D.
//   * A thread owns VEC channels (16 bytes: 8 bf16 or 4 f32) and walks a
//     run of `run` tokens of one sequence; the 128 threads of a block cover
//     128 * VEC neighbouring channels, so each row load is a whole line.
//   * The last KW - 1 inputs stay in registers (a window shifted one token
//     per step), so every input row is read from HBM once; only the KW - 1
//     rows before a run are read again, from L2, by the next run's threads.
//   * The KW taps and the VEC lanes are unrolled (KW up to 8, a template
//     parameter); the weights and bias sit in registers as f32.
//   * The causal left edge is masked in the kernel (no padded copy of x, the
//     reference's jnp.pad); D and L tails are masked, so any D and L >= 1
//     work.  Where D, the strides or a pointer do not allow 16-byte access,
//     the wrapper asks for the one-channel instance (VEC = 1).
// Offsets are 64-bit.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxTaps = 8;

enum Act { kNone = 0, kSilu = 1 };

struct Conv1dArgs {
  const void* x;
  const void* w;
  const void* bias;  // may be null
  void* y;
  int64_t x_batch_stride, x_row_stride;  // elements
  int b, l, d, run, act;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float v, float& out) { out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16& out) { out = __float2bfloat16(v); }

// N values of T at p, widened to f32; one 16-byte load when N values fill it.
template <typename T, int N>
__device__ __forceinline__ void load(const T* p, float (&v)[N]) {
  if constexpr (N * sizeof(T) == 16) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = to_f32(e[j]);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = to_f32(p[j]);
  }
}

template <typename T, int N>
__device__ __forceinline__ void store(T* p, const float (&v)[N]) {
  if constexpr (N * sizeof(T) == 16) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < N; ++j) from_f32(v[j], e[j]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) from_f32(v[j], p[j]);
  }
}

// grid (ceil(D / (128 * VEC)), ceil(L / run), B); D % VEC == 0.
template <typename T, int VEC, int KW>
__global__ void __launch_bounds__(kThreads)
conv1d_causal_kernel(const Conv1dArgs a) {
  const int64_t c0 = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * VEC;
  if (c0 >= a.d) return;
  const int l0 = blockIdx.y * a.run;
  const int l1 = min(l0 + a.run, a.l);
  const T* x = static_cast<const T*>(a.x) + blockIdx.z * a.x_batch_stride + c0;
  T* y = static_cast<T*>(a.y) + static_cast<int64_t>(blockIdx.z) * a.l * a.d + c0;
  const T* w = static_cast<const T*>(a.w) + c0;

  float wt[KW][VEC];
#pragma unroll
  for (int i = 0; i < KW; ++i) load<T, VEC>(w + static_cast<int64_t>(i) * a.d, wt[i]);
  float bias[VEC];
  if (a.bias != nullptr) {
    load<T, VEC>(static_cast<const T*>(a.bias) + c0, bias);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) bias[j] = 0.f;
  }

  // win[i] holds token l - KW + 1 + i; win[KW - 1] is loaded each step.
  float win[KW][VEC];
#pragma unroll
  for (int i = 0; i < KW - 1; ++i) {
    const int t = l0 - (KW - 1) + i;
    if (t >= 0) {
      load<T, VEC>(x + t * a.x_row_stride, win[i]);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) win[i][j] = 0.f;
    }
  }
#pragma unroll 2
  for (int t = l0; t < l1; ++t) {
    load<T, VEC>(x + t * a.x_row_stride, win[KW - 1]);
    float out[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < KW; ++i) acc += win[i][j] * wt[i][j];
      acc += bias[j];
      if (a.act == kSilu) acc = acc / (1.f + expf(-acc));
      out[j] = acc;
    }
    store<T, VEC>(y + static_cast<int64_t>(t) * a.d, out);
#pragma unroll
    for (int i = 0; i < KW - 1; ++i) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) win[i][j] = win[i + 1][j];
    }
  }
}

template <typename T, int VEC, int KW>
int launch_taps(const Conv1dArgs& a, cudaStream_t s) {
  const int64_t threads_d = (a.d + VEC - 1) / VEC;
  const dim3 grid(static_cast<unsigned>((threads_d + kThreads - 1) / kThreads),
                  static_cast<unsigned>((a.l + a.run - 1) / a.run), static_cast<unsigned>(a.b));
  conv1d_causal_kernel<T, VEC, KW><<<grid, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int launch_vec(const Conv1dArgs& a, int kw, cudaStream_t s) {
  switch (kw) {
    case 1: return launch_taps<T, VEC, 1>(a, s);
    case 2: return launch_taps<T, VEC, 2>(a, s);
    case 3: return launch_taps<T, VEC, 3>(a, s);
    case 4: return launch_taps<T, VEC, 4>(a, s);
    case 5: return launch_taps<T, VEC, 5>(a, s);
    case 6: return launch_taps<T, VEC, 6>(a, s);
    case 7: return launch_taps<T, VEC, 7>(a, s);
    case 8: return launch_taps<T, VEC, 8>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool aligned(const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
int launch(const Conv1dArgs& a, int kw, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = a.d % kVec == 0 && a.x_row_stride % kVec == 0 &&
                   a.x_batch_stride % kVec == 0 && aligned(a.x) && aligned(a.w) &&
                   aligned(a.bias) && aligned(a.y);
  return vec ? launch_vec<T, kVec>(a, kw, s) : launch_vec<T, 1>(a, kw, s);
}

}  // namespace

// x: (B,L,D) with channel stride 1, batch and row strides in elements;
// w (KW,D), bias (D,) or null, y (B,L,D) contiguous; run: tokens per
// thread.  act: 0 none, 1 silu.  dtype: 0 = f32, 1 = bf16 for every
// tensor.  Returns a cudaError_t (0 on success).
extern "C" int repro_conv1d_causal(const void* x, const void* w, const void* bias, void* y,
                                   long long x_batch_stride, long long x_row_stride, int b,
                                   int l, int d, int kw, int run, int act, int dtype,
                                   void* stream) {
  if (b <= 0 || l <= 0 || d <= 0 || run <= 0 || kw < 1 || kw > kMaxTaps || act < kNone ||
      act > kSilu || b > 65535 || (l + run - 1) / run > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Conv1dArgs a{x, w, bias, y, x_batch_stride, x_row_stride, b, l, d, run, act};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, kw, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, kw, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
