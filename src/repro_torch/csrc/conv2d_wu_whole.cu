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
// What bounds it on an H100: 2*N*P*Q*K*C*R*S FLOPs at 67 TFLOP/s f32.  At
// ResNet-50's batch-32 shapes every weight gradient but the 56x56 1x1
// 64->64 one lies above the f32 ridge (that one moves 51 MB of x and dO,
// 15 us at 3.35 TB/s, against 12 us of FLOPs); the 52 of a step come to
// 254 GFLOP, a 3.8 ms bound.  So the card must be kept full of FMAs.
//
// The reference's strategy, kept: a block's dW tile stays resident (in
// registers) across its sweep of the (n, p_b) steps, each step reading a
// b_p-row block of dO and the matching rows of the padded plane with no
// bounds tests, and each step's products are summed in a step tile that is
// then added to the resident tile, as the reference's `o_ref +=` adds each
// step's dot product (no one running sum takes all N*P*Q pixels, 100,352
// at the 56x56 layers).  A block owns one (r, s) tap and a BM x BN tile of
// (C, k_blk), since the reference's (R, S, C, k_blk) block is far more
// than a block's registers.
//
// What the TPU's sequential grid forced, changed: there one core walks the
// (n, p_b) steps in order; here blocks run in parallel, and one block per
// tile left 123-131 of the 132 SMs idle on the 56x56 layers (1-9 tiles).
// So the step sequence is cut into `splits` contiguous runs of whole steps
// (never inside a step), one block per (tile, run): grid (C tiles, K/k_blk,
// splits*R*S), about two blocks per SM (kernels/conv2d_wu.plan_whole).
// Each run writes its f32 partial tile into a scratch (splits, R, S, C, K);
// a second kernel, wu_whole_sum_kernel, sums the partials in split order,
// so the result is the same bits on every run (no atomics).  With
// splits == 1 the first kernel writes dW and the second does not run.
//
// Staging: each group of 8 pixels of a step brings 8 x BM channels of x and
// 8 x BN of dO into shared memory by cp.async (16 bytes a copy where C, K,
// k_blk are multiples of 4 and the planes 16-byte aligned, as at every conv
// that reaches K10b; 4 bytes otherwise), into a ring of kStages slots sized
// from the tile to 32 KB (4 slots at 128x128, 5 at 128x64 and 64x128, 8 at
// 64x64), so the loads of the next groups fly while this one is summed.  A
// group past the step's b_p*Q pixels, or a channel past C or k_blk, is
// zero-filled by the copy itself.
//
// The arithmetic stays SIMT f32 FMA: K10b is held to 1e-5 of its plain
// version, and TF32 tensor cores keep about three decimal digits.  Tensor
// cores for the f32 weight gradient are later work for K2 and K10b
// together.  Offsets into xp, dO and the scratch are 64-bit.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 8;             // pixels per staged group
constexpr int kRingBytes = 32768;   // shared memory of the cp.async ring

struct WuWholeArgs {
  const float* xp;    // padded plane (N, HP, WP, C)
  const float* dout;  // (N, P, Q, K)
  float* out;         // (splits, R, S, C, K) partials, or dW when splits == 1
  int n, hp, wp, c, k, r, s, stride, p, q, b_p, k_blk;
  int run;            // (n, p_b) steps per split
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies BYTES from src to dst (shared) asynchronously, or zero-fills dst
// when !ok (src is then not read).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const float* src, bool ok) {
  const int n = ok ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "r"(n)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int BM, int BN, int TM, int TN, int VEC>
__global__ void __launch_bounds__(kThreads)
conv2d_wu_whole_kernel(const WuWholeArgs a) {
  static_assert((BM / TM) * (BN / TN) == kThreads, "one register tile per thread");
  static_assert(TM % 4 == 0 && TN % 4 == 0, "register tiles are float4 groups");
  static_assert(VEC == 4 || VEC == 1, "16- or 4-byte copies");
  constexpr int kStages = kRingBytes / (kPix * (BM + BN) * 4);
  static_assert(kStages >= 2, "a ring of at least two slots");
  constexpr int kARow = BM / VEC;              // copies per pixel of x
  constexpr int kBRow = BN / VEC;              // copies per pixel of dO
  constexpr int kTX = BN / TN;                 // threads along K
  constexpr int kMGroup = BM * 4 / TM;         // row distance between a thread's float4 groups
  constexpr int kNGroup = BN * 4 / TN;
  __shared__ __align__(16) float As[kStages][kPix][BM];
  __shared__ __align__(16) float Bs[kStages][kPix][BN];

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int c0 = blockIdx.x * BM;
  const int k0 = blockIdx.y * a.k_blk;
  const int rs_count = a.r * a.s;
  const int rs = blockIdx.z % rs_count;
  const int split = blockIdx.z / rs_count;
  const int rr = rs / a.s;
  const int ss = rs % a.s;
  const int step_pixels = a.b_p * a.q;
  const int groups = (step_pixels + kPix - 1) / kPix;
  const int p_b = a.p / a.b_p;
  const int step0 = split * a.run;
  const int step_end = min(step0 + a.run, a.n * p_b);
  const int total = (step_end - step0) * groups;  // groups this block sums

  // Group u of this block's run: step step0 + u / groups (image nn, row
  // block pb), pixels (u % groups) * 8 .. + 7 of the step.
  auto load_group = [&](int u, int slot) {
    const int t = step0 + u / groups;
    const int g = u % groups;
    const int nn = t / p_b;
    const int pb = t - nn * p_b;
#pragma unroll
    for (int i = tid; i < kPix * kARow; i += kThreads) {
      const int j = i / kARow;
      const int ch = (i % kARow) * VEC;
      const int px = g * kPix + j;
      const int pl = px / a.q;
      const int qq = px - pl * a.q;
      const int row = (pb * a.b_p + pl) * a.stride + rr;
      const int col = qq * a.stride + ss;
      const bool ok = px < step_pixels && c0 + ch < a.c;
      const float* src =
          ok ? a.xp + (static_cast<int64_t>(nn * a.hp + row) * a.wp + col) * a.c + c0 + ch : a.xp;
      cp_async<VEC * 4>(&As[slot][j][ch], src, ok);
    }
#pragma unroll
    for (int i = tid; i < kPix * kBRow; i += kThreads) {
      const int j = i / kBRow;
      const int ch = (i % kBRow) * VEC;
      const int px = g * kPix + j;
      const int pl = px / a.q;
      const int qq = px - pl * a.q;
      const bool ok = px < step_pixels && ch < a.k_blk;
      const float* src =
          ok ? a.dout + (static_cast<int64_t>(nn * a.p + pb * a.b_p + pl) * a.q + qq) * a.k + k0 + ch
             : a.dout;
      cp_async<VEC * 4>(&Bs[slot][j][ch], src, ok);
    }
  };

  float acc[TM][TN], step[TM][TN];  // the resident tile, this step's sum
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = step[i][j] = 0.f;

#pragma unroll
  for (int u = 0; u < kStages - 1; ++u) {
    if (u < total) load_group(u, u);
    cp_async_commit();
  }
  int slot = 0;                  // slot of group u
  int next_slot = kStages - 1;   // slot of group u + kStages - 1
  for (int u = 0; u < total; ++u) {
    cp_async_wait<kStages - 2>();  // group u has landed (this thread's copies)
    __syncthreads();               // ... everyone's; and group u-1's slot is free
    if (u + kStages - 1 < total) load_group(u + kStages - 1, next_slot);
    cp_async_commit();
#pragma unroll
    for (int kc = 0; kc < kPix; ++kc) {
      float af[TM], bf[TN];
#pragma unroll
      for (int g = 0; g < TM / 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(&As[slot][kc][g * kMGroup + ty * 4]);
        af[g * 4 + 0] = v.x;
        af[g * 4 + 1] = v.y;
        af[g * 4 + 2] = v.z;
        af[g * 4 + 3] = v.w;
      }
#pragma unroll
      for (int g = 0; g < TN / 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(&Bs[slot][kc][g * kNGroup + tx * 4]);
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
    if (u % groups == groups - 1) {  // the step's last group: fold it in
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[i][j] += step[i][j];
          step[i][j] = 0.f;
        }
    }
    slot = slot + 1 == kStages ? 0 : slot + 1;
    next_slot = next_slot + 1 == kStages ? 0 : next_slot + 1;
  }
  cp_async_wait<0>();

  // blockIdx.z = split * R*S + rs: the tile lands at out[split][r][s][c][k]
  float* out = a.out + static_cast<int64_t>(blockIdx.z) * a.c * a.k;
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

// dW[i] = sum over splits, in split order, of part[split][i]: the second
// pass.  Named apart from K2's wu_reduce_kernel and from K10b's first
// kernel, so a profiler trace tells the three apart.
__global__ void __launch_bounds__(kThreads)
wu_whole_sum_kernel(const float* __restrict__ part, float* __restrict__ dw, int64_t len,
                    int splits) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < len;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float sum = part[i];
    for (int sp = 1; sp < splits; ++sp) sum += part[sp * len + i];
    dw[i] = sum;
  }
}

template <int BM, int BN, int TM, int TN>
void launch(const WuWholeArgs& a, int splits, bool vec, cudaStream_t stream) {
  const dim3 grid((a.c + BM - 1) / BM, a.k / a.k_blk, splits * a.r * a.s);
  if (vec)
    conv2d_wu_whole_kernel<BM, BN, TM, TN, 4><<<grid, kThreads, 0, stream>>>(a);
  else
    conv2d_wu_whole_kernel<BM, BN, TM, TN, 1><<<grid, kThreads, 0, stream>>>(a);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Launches K10b on `stream` without synchronising: the split kernel, then
// (when splits > 1) the sum of `partial` (splits, R, S, C, K) into dw.
// Returns the first nonzero cudaGetLastError(), or cudaErrorInvalidValue for
// arguments it does not take.  The caller pads the plane (pad_input), checks
// shapes, dtypes, contiguity, that b_p divides P and that k_blk divides K,
// and picks the tile and the split (kernels/conv2d_wu.plan_whole: tile 0 =
// 128x128, 1 = 128x64, 2 = 64x128, 3 = 64x64 of C x K, with k_blk no more
// than the tile's K; `splits` runs of `run` (n, p_b) steps each).
extern "C" int repro_conv2d_wu_whole_f32(const float* xp, const float* dout, float* partial,
                                         float* dw, int n, int hp, int wp, int c, int k, int r,
                                         int s, int stride, int p, int q, int b_p, int k_blk,
                                         int tile, int splits, int run, void* stream) {
  WuWholeArgs a;
  a.xp = xp;
  a.dout = dout;
  a.out = splits == 1 ? dw : partial;
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
  a.run = run;
  const int64_t steps = static_cast<int64_t>(n) * (b_p > 0 ? p / b_p : 0);
  if (n <= 0 || p <= 0 || q <= 0 || b_p <= 0 || p % b_p || k_blk <= 0 || k % k_blk ||
      splits < 1 || run < 1 || static_cast<int64_t>(splits - 1) * run >= steps ||
      static_cast<int64_t>(splits) * run < steps || static_cast<int64_t>(splits) * r * s > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bn = tile == 0 || tile == 2 ? 128 : 64;
  if (tile < 0 || tile > 3 || k_blk > bn) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = c % 4 == 0 && k % 4 == 0 && k_blk % 4 == 0 && aligned16(xp) && aligned16(dout);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 0: launch<128, 128, 8, 8>(a, splits, vec, st); break;
    case 1: launch<128, 64, 8, 4>(a, splits, vec, st); break;
    case 2: launch<64, 128, 4, 8>(a, splits, vec, st); break;
    default: launch<64, 64, 4, 4>(a, splits, vec, st); break;
  }
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || splits == 1) return err;

  const int64_t len = static_cast<int64_t>(r) * s * c * k;
  const int64_t blocks = (len + kThreads - 1) / kThreads;
  const unsigned grid = static_cast<unsigned>(blocks < 4096 ? blocks : 4096);
  wu_whole_sum_kernel<<<grid, kThreads, 0, st>>>(partial, dw, len, splits);
  return static_cast<int>(cudaGetLastError());
}
