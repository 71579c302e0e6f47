// K5 on Hopper: NHWC max pooling (the ResNet stem pool, 3x3 stride 2 pad 1,
// by default).
//
// Replaces the Pallas kernel repro/kernels/pool2d.py:maxpool2d (_kernel).
// Same function: x (N,H,W,C) -> out (N,P,Q,C), each output the max over its
// window x window input pixels, positions outside the plane counting as
// -inf, the max taken in f32 and cast back to the input type.  Built with
// nvcc for sm_90a and bound through the plain C function at the bottom
// (ctypes; see repro_torch/kernels/_build.py).
//
// What bounds it: bytes.  It does one compare per window element and reads
// each input about (window/stride)^2 times, mostly from L1 and L2, so the
// least time is one read of x and one write of out over 3.35 TB/s.  The
// design is one pass: a thread owns V consecutive channels of one output
// pixel (V of 16 bytes when C and the pointers allow, else 1), loads each
// window position as one vector and writes its result once; consecutive
// threads take consecutive channels, so every warp's loads and stores are
// contiguous.  Padding is handled in the kernel: positions outside the plane
// are skipped, which is a max with -inf, and no padded copy is made.  The max
// propagates NaN, as torch.maximum does.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) { return __float2half_rn(v); }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float max_nan(float m, float v) {
  return (v > m || v != v) ? v : m;  // a NaN in either stays NaN
}

struct PoolArgs {
  const void* x;
  void* out;
  int n, h, w, c, p, q, window, stride, pad;
};

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) maxpool2d_kernel(const PoolArgs a) {
  const T* x = static_cast<const T*>(a.x);
  T* out = static_cast<T*>(a.out);
  const int cv = a.c / V;  // vectors per pixel
  const int64_t total = static_cast<int64_t>(a.n) * a.p * a.q * cv;
  for (int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; idx < total;
       idx += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int ch = static_cast<int>(idx % cv) * V;
    int64_t t = idx / cv;
    const int qq = static_cast<int>(t % a.q);
    t /= a.q;
    const int pp = static_cast<int>(t % a.p);
    const int64_t nn = t / a.p;
    float m[V];
#pragma unroll
    for (int u = 0; u < V; ++u) m[u] = __int_as_float(0xff800000);  // -inf
    const int h0 = pp * a.stride - a.pad;
    const int w0 = qq * a.stride - a.pad;
    for (int wr = 0; wr < a.window; ++wr) {
      const int ih = h0 + wr;
      if (static_cast<unsigned>(ih) >= static_cast<unsigned>(a.h)) continue;
      const T* row = x + ((nn * a.h + ih) * a.w) * a.c + ch;
      for (int wc = 0; wc < a.window; ++wc) {
        const int iw = w0 + wc;
        if (static_cast<unsigned>(iw) >= static_cast<unsigned>(a.w)) continue;
        const Vec<T, V> v = *reinterpret_cast<const Vec<T, V>*>(row + static_cast<int64_t>(iw) * a.c);
#pragma unroll
        for (int u = 0; u < V; ++u) m[u] = max_nan(m[u], to_f32(v.v[u]));
      }
    }
    Vec<T, V> o;
#pragma unroll
    for (int u = 0; u < V; ++u) o.v[u] = from_f32<T>(m[u]);
    *reinterpret_cast<Vec<T, V>*>(out + ((nn * a.p + pp) * a.q + qq) * a.c + ch) = o;
  }
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

template <typename T, int V>
int launch(const PoolArgs& a, cudaStream_t stream) {
  const int64_t total = static_cast<int64_t>(a.n) * a.p * a.q * (a.c / V);
  const int64_t want = (total + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 32LL * sm_count() ? want : 32LL * sm_count());
  maxpool2d_kernel<T, V><<<blocks, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_vec(const PoolArgs& a, cudaStream_t stream) {
  constexpr int kV = 16 / sizeof(T);
  const bool vec = a.c % kV == 0 && (reinterpret_cast<uintptr_t>(a.x) & 15u) == 0 &&
                   (reinterpret_cast<uintptr_t>(a.out) & 15u) == 0;
  return vec ? launch<T, kV>(a, stream) : launch<T, 1>(a, stream);
}

}  // namespace

// Launches K5 on `stream` without synchronising and returns
// cudaGetLastError(): nonzero means the launch was refused or an earlier
// fault is pending.  dtype: 0 float32, 1 float16, 2 bfloat16.  The caller
// checks shapes, dtype and contiguity.
extern "C" int repro_maxpool2d(const void* x, void* out, int n, int h, int w, int c, int window,
                               int stride, int pad, int dtype, void* stream) {
  PoolArgs a;
  a.x = x;
  a.out = out;
  a.n = n;
  a.h = h;
  a.w = w;
  a.c = c;
  a.window = window;
  a.stride = stride;
  a.pad = pad;
  a.p = (h + 2 * pad - window) / stride + 1;
  a.q = (w + 2 * pad - window) / stride + 1;
  if (n <= 0 || c <= 0 || a.p <= 0 || a.q <= 0 || window <= 0 || stride <= 0 || pad < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_vec<float>(a, st);
    case 1: return launch_vec<__half>(a, st);
    case 2: return launch_vec<__nv_bfloat16>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
